"""The coordinator/worker control plane over HTTP (reference:
presto_tpu/server): `node` (the worker and the exchange data plane),
`coordinator` (dispatch, admission and the client protocol),
`scheduler` (live membership) and `serde` (the page wire format)."""
