"""Domain decomposition: per-cell Schur condensation, the interface solver
and the reduced-basis Schur surrogate (PyTorch port of
``pylatticedso_tpu.ddm``)."""
