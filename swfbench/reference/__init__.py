"""The plain reference the check compares with: plain PyTorch, nothing
of the program under test."""
