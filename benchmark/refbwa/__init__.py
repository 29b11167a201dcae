"""A plain reference of BWA-MEM's scalar semantics, in Python and NumPy.

It is the yardstick the benchmark holds the aligner under test to: it
builds its own FM-index from the genome (``fm``), finds SMEMs, chains,
filters, extends (``ksw``, ``mem``), pairs and rescues mates (``pe``), and
writes SAM records, independently of the program. It imports nothing of
the program and no compiled code of its own.
"""
