"""C-MinHash core: permutations, band hashing and the signing engine."""
