"""Model plane: the attention, MoE, encoder-decoder and RWKV6 layer kinds on
the reference's stack, with causal train and prefill attention on kernel B4
and the training loss."""

from .config import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig
from .convert import params_from_numpy
from .lm import Model
