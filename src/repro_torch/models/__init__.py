"""Model plane: the attention and MoE layer kinds on the reference's stack,
with train and prefill attention on kernel B4 and the training loss."""

from .config import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig
from .convert import params_from_numpy
from .lm import Model
