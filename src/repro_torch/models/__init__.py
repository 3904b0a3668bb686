"""Model substrate (dense attention and rwkv6 families) for the port."""

from repro_torch.models.transformer import (decode_step, forward, init_params,
                                            make_cache, prefill)

__all__ = ["init_params", "forward", "prefill", "make_cache", "decode_step"]
