"""Plain references that decide ``correct``: torch and the standard library
only, nothing of the program."""
