"""Plain references that decide ``correct``: a float32 PyTorch forward of
the served models and a frozen NumPy copy of NetKV's decision (Eq. 2-7).
They import nothing of the program."""
