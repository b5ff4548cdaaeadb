"""AdamW, its schedule and int8 gradient compression, on parameter trees."""

from .adamw import (
    AdamW,
    AdamWState,
    CompressionState,
    compress_decompress,
    compress_init,
    cosine_schedule,
    global_norm,
)
