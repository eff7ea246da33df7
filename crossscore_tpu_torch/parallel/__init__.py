"""Several ranks of one node: process groups and the (data, model) grid
(``mesh``), the rank launcher (``launch``), the collectives
(``collectives``), tensor parallelism (``tensor_parallel``) and view
parallelism (``view_parallel``)."""
