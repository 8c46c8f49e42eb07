"""The plain fp32 reference of the benchmark's models and the output
checks that read it; it imports nothing of the program."""
