"""Device kernels for the relational operators (reference:
presto_tpu/ops): functions over Batch tensors."""
