"""Data pipelines for training: the seekable synthetic LM stream."""

from .pipeline import SyntheticLM
