"""The training cell's prepare, host seconds from the CSR adjacency to the
GCN and its optimizer on the card (normalization, symmetry check, pack,
upload), read in traced runs too."""
from bench_h100.readers import prepare_s as read  # noqa: F401
