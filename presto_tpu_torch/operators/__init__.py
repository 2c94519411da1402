"""Host-side operator pipeline (reference: presto_tpu/operators;
Operator.java:20 contract, Driver.java:68 loop). The work inside each
operator is PyTorch ops and the port's hand-written CUDA kernels."""
