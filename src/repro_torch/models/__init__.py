"""Model substrate (dense attention family) for the port."""

from repro_torch.models.transformer import forward, init_params, prefill

__all__ = ["init_params", "forward", "prefill"]
