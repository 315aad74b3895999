"""Hand-written kernels and the compositions that share their layouts.

`spmm_csr` is the one-pass CSR SpMM in Pallas through Triton (GPU);
`spmm_stream` is the tiled slot-layout SpMM with an XLA segment reduce;
`gat_fused` composes the attention chain over that slot layout.  The op
layer (`ops/spmm.py`) chooses among them and the plain XLA formulation in
`ops/reference.py`.
"""
