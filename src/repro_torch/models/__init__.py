"""Model families of the port. So far the ssm family (mamba2-130m); the
dense, MoE, hybrid and enc-dec families wait for their slices."""
from repro_torch.models.api import get_model, make_batch

__all__ = ["get_model", "make_batch"]
