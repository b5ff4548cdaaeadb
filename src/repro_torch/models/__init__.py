"""Model plane: the attention layer kinds on the reference's stack, with
prefill attention on kernel B4."""

from .config import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig
from .convert import params_from_numpy
from .lm import Model
