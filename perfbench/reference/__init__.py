"""The plain reference the program's outputs are judged by."""
