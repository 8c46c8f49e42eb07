"""Model code of the port (dense decoder family)."""
