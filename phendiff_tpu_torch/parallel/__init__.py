"""Parallelism over processes: the data and model axes and data parallelism
(``parallel/mesh.py``), tensor parallelism over the model axis
(``parallel/tp.py``).  Import from the submodules."""
