"""Model families of the port: dense, vlm, ssm and hybrid; the MoE and
enc-dec families wait for their slices (ROADMAP A7, A9)."""
from repro_torch.models.api import get_model, make_batch

__all__ = ["get_model", "make_batch"]
