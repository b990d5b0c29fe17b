"""Device us a call in the stripe folds (hisparse.stripe_fold), pokec cells."""
from bench_h100.spans import stripe_fold_us as read  # noqa: F401
