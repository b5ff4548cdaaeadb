"""Hand-written Hopper kernels, each beside its plain PyTorch twin."""
from .fcfs_queue import fcfs_scan, fcfs_scan_cuda, fcfs_scan_plain
