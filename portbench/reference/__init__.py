"""The plain reference that decides ``correct``: plain ``torch`` on a flat
dict of weights, imports nothing of the program."""
