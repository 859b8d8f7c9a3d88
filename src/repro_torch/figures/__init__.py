"""The paper's figures on the port: twins of the reference's
``benchmarks/common.py``, ``table1_perplexity.py`` and ``fig3``,
``fig8``-``fig12``. Each figure runs as
``python -m repro_torch.figures.<name> [--device cpu]`` (the card by
default), prints the reference's CSV rows under the same names and
asserts the orderings the reference asserts, with the same tolerances.
Every cast is the reference's default cast (``common.cast_tree``: the
table-driven encoder, on the card the quantizer kernel's table
instances)."""
