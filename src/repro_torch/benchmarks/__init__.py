"""The paper's benchmarks on the port (ports of the top-level
``benchmarks/`` modules): the encoder-like substrate (``common``),
Table 2 (``table2``), Figure 1 (``figure1``) and the C(q) distribution
(``clabel_dist``).  Each runs on the CUDA card unless given
``device="cpu"``."""
