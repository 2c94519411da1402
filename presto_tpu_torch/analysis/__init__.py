"""Static expression typing (reference: presto_tpu/analysis/expr_types.py;
the jaxpr kernel-contract checker has no counterpart yet)."""
