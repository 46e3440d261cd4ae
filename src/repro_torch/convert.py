"""Carry index, search, learner, model and optimizer state across from
numpy.

The port cannot import JAX, so a caller that holds JAX state turns it into
numpy first (``np.asarray`` of each leaf) and hands the dict here; both
packages then compute from the very same leaves. Storage dtypes are kept:
codes uint8 (K ≤ 256), ids and offsets int32. Model and optimizer leaves
are keyed by the JAX path keys (``item_table``, ``user0_w``, ``index/R``,
``index/codebooks``; ``training.optimizer.path_key``); the transformer's
leaves come as the JAX package's nested dict (``layers/attn/wq``, ``kvq``).
A bfloat16 leaf (numpy's ``ml_dtypes`` bfloat16, which torch cannot take
directly) goes across through float32, which holds it exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import quant
from repro_torch import rotations as rot_lib
from repro_torch.core import index_layer as il
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.models import recsys
from repro_torch.models import transformer as tfm
from repro_torch.rotations.cayley import CayleyState
from repro_torch.rotations.gcd import GCDState
from repro_torch.rotations.procrustes import ProcrustesState
from repro_torch.search import exact as search_exact
from repro_torch.search import flat as search_flat
from repro_torch.training import optimizer as opt_lib

INDEX_KEYS = ("R", "centroids", "codebooks", "codes", "ids", "list_offsets",
              "block_size")


def _t(a, dev: torch.device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a, dtype=dtype))
    return torch.from_numpy(arr.copy()).to(dev)


def index_from_numpy(arrays: dict, *, device=None) -> IVFPQIndex:
    """An ``IVFPQIndex`` on ``device`` (the card by default) from the JAX
    index's arrays: keys ``R``, ``centroids``, ``codebooks``, ``codes``,
    ``ids``, ``list_offsets`` and ``block_size``. Codebooks (D, K, sub)
    make a ``PQ``, (M, D, K, sub) a depth-M ``RQ``."""
    missing = [k for k in INDEX_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"index_from_numpy: missing {missing}")
    dev = _device.resolve(device)
    codebooks = np.asarray(arrays["codebooks"])
    if codebooks.ndim not in (3, 4):
        raise ValueError(f"index_from_numpy: codebooks of shape "
                         f"{codebooks.shape}, expected (D, K, sub) or "
                         "(M, D, K, sub)")
    kind = quant.PQ if codebooks.ndim == 3 else quant.RQ
    quantizer = kind(_t(codebooks, dev, np.float32))
    code_dtype = quantizer.config.code_dtype()
    return IVFPQIndex(
        R=_t(arrays["R"], dev, np.float32),
        coarse=quant.VQ(_t(arrays["centroids"], dev, np.float32)),
        quantizer=quantizer,
        codes=_t(arrays["codes"], dev, code_dtype),
        ids=_t(arrays["ids"], dev, np.int32),
        list_offsets=_t(arrays["list_offsets"], dev, np.int32),
        block_size=int(arrays["block_size"]))


FUSED_KEYS = ("rot", "wacc", "qdelta")


def adc_state_from_numpy(arrays: dict, *, fused: bool, nprobe: int = 8,
                         lut_dtype: str = "float32",
                         device=None) -> search_flat.ADCState:
    """An ``ADCState`` (the ``ivf`` and ``flat_adc`` state) on ``device``
    from a JAX ``ADCState``'s leaves: the index keys of
    ``index_from_numpy`` and, when ``fused``, the fused-refresh matrices
    ``rot``, ``wacc`` and ``qdelta``, so a state taken after several fused
    refreshes carries across as it stands."""
    index = index_from_numpy(arrays, device=device)
    state = search_flat.ADCState(
        index=index, max_blocks=index.max_list_blocks(),
        nprobe=min(nprobe, index.num_lists), lut_dtype=lut_dtype)
    if not fused:
        return state
    missing = [k for k in FUSED_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"adc_state_from_numpy: fused, missing {missing}")
    state = search_flat._fused_state(state)
    return dataclasses.replace(
        state, **{k: _t(arrays[k], index.device, np.float32)
                  for k in FUSED_KEYS})


def exact_state_from_numpy(arrays: dict, *,
                           device=None) -> search_exact.ExactState:
    """An ``ExactState`` on ``device`` from a JAX one's leaves: ``R``,
    ``XR``, ``ids``, ``tile_rows`` and ``R0`` (None or absent in eager
    mode)."""
    dev = _device.resolve(device)
    R0 = arrays.get("R0")
    return search_exact.ExactState(
        R=_t(arrays["R"], dev, np.float32),
        XR=_t(arrays["XR"], dev, np.float32),
        ids=_t(arrays["ids"], dev, np.int32),
        tile_rows=int(arrays["tile_rows"]),
        R0=None if R0 is None else _t(R0, dev, np.float32))


def gcd_state_from_numpy(arrays: dict, *, device=None) -> GCDState:
    """A ``GCDState`` on ``device`` from a JAX ``GCDState``'s fields: ``R``
    and optionally ``step`` and the preconditioner accumulators ``accum``
    and ``accum2`` ((n, n) float32; zeros where they are not given, as a
    fresh state has them)."""
    dev = _device.resolve(device)
    R = _t(arrays["R"], dev, np.float32)
    n = R.shape[-1]

    def acc(key):
        a = arrays.get(key)
        if a is None:
            return torch.zeros((n, n), dtype=torch.float32, device=dev)
        if np.shape(a) != (n, n):
            raise ValueError(f"gcd_state_from_numpy: {key} has shape "
                             f"{np.shape(a)}, R gives {(n, n)}")
        return _t(a, dev, np.float32)

    return GCDState(R=R, step=_t(arrays.get("step", 0), dev, np.int32),
                    accum=acc("accum"), accum2=acc("accum2"))


def procrustes_state_from_numpy(arrays: dict, *,
                                device=None) -> ProcrustesState:
    """A ``ProcrustesState`` on ``device`` from numpy arrays: ``R`` and
    optionally ``step``, the fields of the JAX ``ProcrustesState``."""
    dev = _device.resolve(device)
    return ProcrustesState(R=_t(arrays["R"], dev, np.float32),
                           step=_t(arrays.get("step", 0), dev, np.int32))


def cayley_state_from_numpy(arrays: dict, *, device=None) -> CayleyState:
    """A ``CayleyState`` on ``device`` from numpy arrays: ``R`` and
    optionally ``step``, the fields of the JAX ``CayleyState``."""
    dev = _device.resolve(device)
    return CayleyState(R=_t(arrays["R"], dev, np.float32),
                       step=_t(arrays.get("step", 0), dev, np.int32))


def twotower_params_from_numpy(arrays: dict, cfg: recsys.TwoTowerConfig, *,
                               device=None) -> recsys.TwoTower:
    """A ``TwoTower`` on ``device`` from the JAX model's leaves, keyed by
    path: every key of ``recsys.twotower_specs(cfg)``, and ``index/R`` with
    ``index/codebooks`` when ``cfg.index`` is set. Shapes are checked."""
    dev = _device.resolve(device)
    specs = recsys.twotower_specs(cfg)
    want = dict((k, s.shape) for k, s in specs.items())
    if cfg.index is not None:
        n, D = cfg.index.dim, cfg.index.num_subspaces
        want["index/R"] = (n, n)
        want["index/codebooks"] = (D, cfg.index.num_codewords, n // D)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise KeyError(f"twotower_params_from_numpy: missing {missing}, "
                       f"unexpected {extra}")
    for k, shape in want.items():
        if np.shape(arrays[k]) != tuple(shape):
            raise ValueError(f"{k}: shape {np.shape(arrays[k])}, the config "
                             f"gives {tuple(shape)}")
    tensors = {k: _t(arrays[k], dev, np.float32) for k in specs}
    index = None
    if cfg.index is not None:
        index = il.IndexLayer(_t(arrays["index/R"], dev, np.float32),
                              _t(arrays["index/codebooks"], dev, np.float32))
    return recsys.TwoTower(tensors, index)


def opt_state_from_numpy(arrays: dict, cfg: opt_lib.OptimizerConfig, *,
                         device=None) -> opt_lib.OptState:
    """An ``OptState`` on ``device`` from the JAX one: ``mu`` and ``nu``
    (path key -> array), ``step``, and ``rot`` (path key -> the learner
    state's fields: ``R`` and ``step`` for every learner, and GCD's
    ``accum`` and ``accum2``). A field the learner's state lacks is an
    error; one the arrays lack keeps the fresh state's value."""
    dev = _device.resolve(device)
    learner = rot_lib.from_config(cfg.rotation)
    rot = {}
    for k, fields in arrays.get("rot", {}).items():
        st = learner.init_from(_t(fields["R"], dev, np.float32))
        extra = sorted(set(fields) - set(st._fields))
        if extra:
            raise KeyError(f"opt_state_from_numpy {k}: {extra} are not "
                           f"fields of {type(st).__name__}")
        rot[k] = st._replace(**{
            f: _t(fields[f], dev, np.int32 if f == "step" else np.float32)
            for f in st._fields if f != "R" and f in fields})
    return opt_lib.OptState(
        mu={k: _t(v, dev, np.float32) for k, v in arrays["mu"].items()},
        nu={k: _t(v, dev, np.float32) for k, v in arrays["nu"].items()},
        rot=rot, step=int(np.asarray(arrays["step"])))


def _leaf(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy leaf of any float dtype (bfloat16 included) as ``dtype``."""
    arr = np.asarray(a)
    if arr.dtype.kind not in "biu":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(
        device=dev, dtype=dtype)


def transformer_params_from_numpy(arrays: dict, cfg: tfm.TransformerConfig,
                                  *, device=None) -> dict:
    """The transformer's parameters on ``device`` from the JAX model's
    nested leaves (``embed``, ``head``, ``layers/...``, ``ln_f`` and
    ``kvq/{rot_k, rot_v, cb_k, cb_v}`` as the config has them), in the
    config's param dtype. Keys and shapes are checked against
    ``param_specs(cfg)``."""
    dev = _device.resolve(device)

    def carry(specs: dict, arrs: dict, path: str) -> dict:
        missing = sorted(set(specs) - set(arrs))
        extra = sorted(set(arrs) - set(specs))
        if missing or extra:
            raise KeyError(f"transformer_params_from_numpy{path}: missing "
                           f"{missing}, unexpected {extra}")
        out = {}
        for k, spec in specs.items():
            if isinstance(spec, dict):
                out[k] = carry(spec, arrs[k], f"{path}/{k}")
                continue
            if np.shape(arrs[k]) != tuple(spec.shape):
                raise ValueError(f"{path}/{k}: shape {np.shape(arrs[k])}, "
                                 f"the config gives {tuple(spec.shape)}")
            out[k] = _leaf(arrs[k], dev, spec.dtype or cfg.param_dtype)
        return out

    return carry(tfm.param_specs(cfg), arrays, "")


def decode_cache_from_numpy(arrays: dict, *, device=None):
    """A ``DecodeCache`` (keys ``k``, ``v``, ``length``) or a
    ``PQDecodeCache`` (``k_codes``, ``v_codes``, ``length``) on ``device``
    from a JAX cache's leaves. Codes stay uint8, lengths int32; dense
    entries stay bfloat16 if they are, else float32."""
    dev = _device.resolve(device)
    length = _t(arrays["length"], dev, np.int32)
    if "k_codes" in arrays:
        return tfm.PQDecodeCache(
            k_codes=_t(arrays["k_codes"], dev, np.uint8),
            v_codes=_t(arrays["v_codes"], dev, np.uint8), length=length)
    bf16 = np.asarray(arrays["k"]).dtype.name == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    return tfm.DecodeCache(k=_leaf(arrays["k"], dev, dtype),
                           v=_leaf(arrays["v"], dev, dtype), length=length)
