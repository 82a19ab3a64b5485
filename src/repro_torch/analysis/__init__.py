"""Cost analysis of traced programs (``hlo``), the roofline over dry-run
records and the kernels (``roofline``), and sweep comparison
(``compare``): the counterparts of ``repro.analysis``."""
