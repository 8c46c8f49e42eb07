"""The plain fp32 reference of the benchmark's models (the shared pieces
in ``model``, composed by each family's module under ``families/``) and
the output checks that read it; it imports nothing of the program."""
