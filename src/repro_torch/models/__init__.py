"""Model families of the port: dense, vlm, moe, ssm and hybrid
(``transformer``), and enc-dec (``encdec``)."""
from repro_torch.models.api import get_model, make_batch

__all__ = ["get_model", "make_batch"]
