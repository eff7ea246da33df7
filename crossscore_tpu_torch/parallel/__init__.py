"""Several ranks of one node: process groups (``mesh``), the rank launcher
(``launch``) and view-parallel predict (``view_parallel``)."""
