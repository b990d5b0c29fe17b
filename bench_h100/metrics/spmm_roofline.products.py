"""The SpMM path's share of its roofline at F = 100, 256 and 47: the CSR work's
bound over the device time under the aggregation spans."""
from bench_h100.train_readers import spmm_roofline as read  # noqa: F401
