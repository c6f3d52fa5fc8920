"""The plain reference of the port's benchmark: the patience IVF search
and the needed-work counts.  Imports nothing of the program."""
