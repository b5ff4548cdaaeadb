"""Model serving behind the paper's probabilistic scheduler."""
from .router import ReplicaPool, Router
