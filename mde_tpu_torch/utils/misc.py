"""Small host-side utilities, the port's own copy of what it needs from
`mde_tpu/utils/misc.py` (numpy and matplotlib, no framework)."""

import numpy as np


def colorize(value_hw, vmin=10, vmax=1000, cmap="magma_r", invalid_value=-1):
    """Depth map (H, W) -> uint8 RGB via a matplotlib colormap
    (reference utils.py:92-112)."""
    import matplotlib

    value = np.asarray(value_hw)
    invalid_mask = value == invalid_value

    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    cmapper = matplotlib.colormaps[cmap]
    value = cmapper(value, bytes=True)
    value[invalid_mask] = 255
    return value[:, :, :3]
