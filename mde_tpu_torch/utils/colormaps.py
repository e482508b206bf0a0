"""The colormaps that the port's pictures use, without matplotlib: `magma`
and `inferno` as 256-entry lookup tables, their `_r` maps the same tables
reversed, applied by matplotlib's own rule, and `imshow`'s `Normalize`.

The tables are matplotlib 3.10.8's `colormaps[name]` read as bytes
(`(cmap._lut * 255).astype(uint8)`, RGB; every entry's alpha is 255). The
card's machine has no matplotlib; `tests/test_torch_port_figures.py` holds
the tables and the rule against it.
"""

import numpy as np

_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f03031104031304041505041706051907051b0806"
    "1d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31120d33140d35150e38160e3a170f3c18"
    "0f3f1a10411b10441c10461e10491f114b20114d2211502311522511552611572811592a115c2b115e2d1060"
    "2f1062301065321067341068350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f"
    "774810784a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e5d177e5e"
    "177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e816f1e81711f81731f81742081"
    "7621817721817922817a22817c23817e24817f24818125818225818426818526818727818928818a28818c29"
    "808d29808f2a80912a80922b80942b80952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4"
    "307da6317da7317da9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070d0416fd1426ed342"
    "6dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66e14c66e24d65e44e64e55063e65162e7"
    "5262e85461ea5560eb5660ec585fed595fee5b5eee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb84"
    "60fb8660fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6bfd9f6cfd"
    "a16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37bfeb57cfeb77dfeb97ffebb80"
    "febc82febe83fec085fec286fec488fec689fec78bfec98dfecb8efdcd90fdcf92fdd193fdd295fdd497fdd6"
    "98fdd89afdda9cfddc9dfddd9ffddfa1fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fc"
    "f1b3fcf3b5fcf5b7fbf7b9fbf9bbfbfabdfbfcbf"
)

_INFERNO_HEX = (
    "00000300000400000601000701010901010b02010e02021003021204031404031605041806041b07051d0806"
    "1f0906210a07230b07260d08280e082a0f092d10092f120a32130a34140b36160b39170b3b190b3e1a0b401c"
    "0c431d0c451f0c47200c4a220b4c240b4e260b50270b52290b542b0a562d0a582e0a5a300a5c32095d34095f"
    "3509603709613909623b09643c09653e0966400966410967430a68450a69460a69480b6a4a0b6a4b0c6b4d0c"
    "6b4f0d6c500d6c520e6c530e6d550f6d570f6d58106d5a116d5b116e5d126e5f126e60136e62146e63146e65"
    "156e66156e68166e6a176e6b176e6d186e6e186e70196e72196d731a6d751b6d761b6d781c6d7a1c6d7b1d6c"
    "7d1d6c7e1e6c801f6b811f6b83206b85206a86216a88216a8922698b22698d23698e24689024689125679325"
    "679526669626669827659928649b28649c29639e2963a02a62a12b61a32b61a42c60a62c5fa72d5fa92e5eab"
    "2e5dac2f5cae305baf315bb1315ab23259b43358b53357b73456b83556ba3655bb3754bd3753be3852bf3951"
    "c13a50c23b4fc43c4ec53d4dc73e4cc83e4bc93f4acb4049cc4148cd4247cf4446d04544d14643d24742d448"
    "41d54940d64a3fd74b3ed94d3dda4e3bdb4f3adc5039dd5238de5337df5436e05634e25733e35832e45a31e5"
    "5b30e65c2ee65e2de75f2ce8612be9622aea6428eb6527ec6726ed6825ed6a23ee6c22ef6d21f06f1ff0701e"
    "f1721df2741cf2751af37719f37918f47a16f57c15f57e14f68012f68111f78310f7850ef8870df8880cf88a"
    "0bf98c09f98e08f99008fa9107fa9306fa9506fa9706fb9906fb9b06fb9d06fb9e07fba007fba208fba40afb"
    "a60bfba80dfbaa0efbac10fbae12fbb014fbb116fbb318fbb51afbb71cfbb91efabb21fabd23fabf25fac128"
    "f9c32af9c52cf9c72ff8c931f8cb34f8cd37f7cf3af7d13cf6d33ff6d542f5d745f5d948f4db4bf4dc4ff3de"
    "52f3e056f3e259f2e45df2e660f1e864f1e968f1eb6cf1ed70f1ee74f1f079f1f27df2f381f2f485f3f689f4"
    "f78df5f891f6fa95f7fb99f9fc9dfafda0fcfea4"
)


N = 256


def _table(hex_rgb: str) -> np.ndarray:
    rgb = np.frombuffer(bytes.fromhex(hex_rgb), np.uint8).reshape(N, 3)
    return np.concatenate([rgb, np.full((N, 1), 255, np.uint8)], axis=1)


_TABLES = {"magma": _table("".join(_MAGMA_HEX)), "inferno": _table("".join(_INFERNO_HEX))}
_BAD = np.zeros(4, np.uint8)  # matplotlib's default bad colour: transparent black


def _lookup_table(name: str) -> np.ndarray:
    """`name`'s (N + 3, 4) uint8 table as matplotlib's `_lut` in bytes: the N
    colours, then under (the first), over (the last) and bad. An `_r` name
    reverses the N colours, and under and over with them."""
    table = _TABLES[name.removesuffix("_r")]
    if name.endswith("_r"):
        table = table[::-1]
    return np.concatenate([table, table[:1], table[-1:], _BAD[None]])


def apply_colormap(name: str, x, bad=None) -> np.ndarray:
    """`matplotlib.colormaps[name](x, bytes=True)`: (..., 4) uint8 RGBA.

    A float `x` is scaled by N in its own dtype, and 1 (N after the scale)
    goes to the last colour; below 0 takes the under colour, N and above the
    over colour, and `bad` (NaN where not given, as for an unmasked array;
    a masked array's mask) the bad one."""
    xa = np.array(x, copy=True)
    if xa.dtype.kind == "f":
        xa *= N
        xa[xa == N] = N - 1
    under, over = xa < 0, xa >= N
    if bad is None:
        bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        index = xa.astype(int)
    index[under], index[over], index[bad] = N, N + 1, N + 2
    return _lookup_table(name).take(index, axis=0, mode="clip")


def _float_dtype(a: np.ndarray) -> np.dtype:
    """Normalize.process_value's dtype: integers and booleans to at least
    float32, floats as they are."""
    if np.issubdtype(a.dtype, np.integer) or a.dtype.type is np.bool_:
        return np.promote_types(a.dtype, np.float32)
    return a.dtype


def normalize(value, vmin, vmax) -> np.ndarray:
    """`matplotlib.colors.Normalize(vmin, vmax)(value)` without clipping:
    (value - vmin) / (vmax - vmin) in place on a copy in the value's float
    dtype, each bound in its own (a numpy float32 bound subtracts in float32,
    a Python float in float64, rounded back), or zeros where vmin equals
    vmax."""
    value = np.asarray(value)
    result = value.astype(_float_dtype(value), copy=True)
    vmin, vmax = (np.asarray([v]) for v in (vmin, vmax))
    vmin, vmax = vmin.astype(_float_dtype(vmin))[0], vmax.astype(_float_dtype(vmax))[0]
    if vmin == vmax:
        result.fill(0)
    elif vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        result -= vmin
        result /= (vmax - vmin)
    return result


def imshow_rgba(value, vmin=None, vmax=None, cmap: str = None) -> np.ndarray:
    """The (H, W, 4) uint8 RGBA that `ax.imshow(value, vmin=vmin, vmax=vmax,
    cmap=cmap).to_rgba(get_array(), bytes=True)` gives for a 2-D float map
    (NaN and inf masked, vmin and vmax the data's where not given; `cmap`
    one of this module's), or for an (H, W, 3) image: uint8 as it is with
    alpha 255, float (in [0, 1]) times 255 truncated, NaN pixels
    transparent black."""
    value = np.asarray(value)
    if value.ndim == 3:
        if value.shape[2] != 3:
            raise ValueError("an image panel is (H, W, 3)")
        out = np.empty((*value.shape[:2], 4), value.dtype)
        out[..., :3] = value
        out[..., 3] = 255 if value.dtype == np.uint8 else 1
        if value.dtype == np.uint8:
            return out
        nans = np.isnan(value).any(axis=2)
        out[nans] = 0
        if out.max() > 1 or out.min() < 0:
            raise ValueError("Floating point image RGB values must be in the 0..1 range.")
        return (out * 255).astype(np.uint8)
    if cmap is None:
        raise ValueError("a 2-D map needs a cmap: magma, inferno or their _r maps")
    bad = ~np.isfinite(value)
    finite = value[~bad]
    vmin = finite.min() if vmin is None else vmin
    vmax = finite.max() if vmax is None else vmax
    return apply_colormap(cmap, normalize(value, vmin, vmax), bad=bad)
