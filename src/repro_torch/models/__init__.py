"""Model families of the port: dense, vlm, moe, ssm and hybrid; the enc-dec
family waits for its slice (ROADMAP A9)."""
from repro_torch.models.api import get_model, make_batch

__all__ = ["get_model", "make_batch"]
