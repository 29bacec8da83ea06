"""The plain reference of each configuration: plain PyTorch and NumPy that
imports nothing of the program. The program's outputs are what is judged;
the reference works out every derived value again from the inputs the
benchmark made."""
