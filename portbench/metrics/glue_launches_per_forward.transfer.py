"""The DiT blocks' and final layer's elementwise and LayerNorm launches a
denoiser call (norm, modulate, gate-and-residual, GELU): the port's
counters ``models.dit.glue_launches`` over ``models.dit.forward_calls``,
over the whole run.  None where the port has no such counters or ran no
DiT forward."""


def read(r):
    try:
        from phendiff_tpu_torch.models import dit
    except ImportError:
        return None
    calls = getattr(dit, "forward_calls", 0)
    return getattr(dit, "glue_launches", 0) / calls if calls else None
