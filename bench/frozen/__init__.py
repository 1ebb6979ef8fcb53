"""Frozen copies of the program's arrival processes and roofline
arithmetic; each file names the file and the commit it was copied from."""
