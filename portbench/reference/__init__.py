"""The plain reference: the join optimizer's semantics in NumPy, written
apart from the program.  It imports nothing of the program and reads only
the wire dict of a query (see ``portbench/traffic/wire.py``)."""
