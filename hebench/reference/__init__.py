"""The plain reference that decides `correct`: torch, numpy and the
standard library only, nothing of the program under test."""
