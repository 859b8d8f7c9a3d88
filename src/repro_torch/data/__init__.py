"""Deterministic data sources and the host-sharded iterator (the
reference's ``data``)."""
from .pipeline import SyntheticLM, TextCorpus, make_data_iter

__all__ = ["SyntheticLM", "TextCorpus", "make_data_iter"]
