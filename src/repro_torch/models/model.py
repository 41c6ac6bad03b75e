"""Model facade (``repro/models/model.py``): one API over every assigned
family: dense, MoE, MLA, the Jamba hybrid, xLSTM, the VLM (M-RoPE) and
the encoder-decoder (whisper).

  build_model(cfg, ctx=None, device=None, **kw)  ->  Model with
    .init(seed_or_key)                params (float32 master), installed
    .load_params(tree)                install a parameter tree (a copy)
    .use_params(tree)                 adopt a tree's tensors (no copy)
    .hidden_seq(batch, params=, remat=)  (B, S, D) final hidden
    .unembed(params=)                 the (V, D) output matrix
    .logits_seq(batch)                (B, S, V)
    .prefill(batch, cache_len)        (last-token logits (B, V), caches)
    .decode(tokens, pos, caches)      ((B, 1, V) logits, caches)
    .init_cache(batch, cache_len, dtype)

The model holds its parameters (an ``nn.Module`` whose submodules follow
the reference's tree: ``weights.layers.pos0.attn.wq``), so the methods
take no ``params`` argument. ``batch`` is a dict with the reference's
keys, numpy arrays or tensors:

  dense / moe / hybrid / ssm : tokens (B, S) ints
  vlm                        : embeds (B, S, D) + positions (3, B, S) ints
  audio (enc-dec)            : frames (B, enc_seq, D) + tokens (B, S) ints

Decode embeds text tokens in every family; it writes the new cache row
in place and returns the same cache tensors; ``pos`` is a Python int,
the token's cache index, which is also its position (on all three M-RoPE
streams, as in the reference).

The compute dtype is ``cfg.dtype`` (bfloat16 for the assigned configs).
The reference casts each float32 weight to it at each use. Serving
(``prefill``, ``decode``, ``hidden_seq`` without ``params``) uses one
cast copy (``compute_params``), made on first use after the weights
change: the same bits, without reading the float32 weights and writing a
fresh copy on every step. The leaves the reference reads in float32 stay
float32 (``transformer.cast_tree``: norm scales, LayerNorms' scales and
biases, ``_FLOAT32_LEAVES``). A model whose float32 masters
and a cast copy do not fit on the card together takes
``cast_at_use=True``: serving then casts each block's masters at its use
and holds no copy.
Training passes the float32 masters as ``params``: ``hidden_seq`` then
casts them inside the autograd graph at each block, as the reference
does, so the gradients land on the float32 leaves (``training/``); an
optimizer update installs its new tensors with ``use_params``, which
drops the cast copy.

Runs on ``cuda:0`` unless the caller passes ``device``; with no card and
no ``device`` it raises.

On a mesh (``ctx``: a ``ShardingCtx`` whose mesh is a ``DeviceMesh``,
one SPMD process a rank) the model holds this rank's block of every
parameter (``param_spec``; ``sharding/layout.py``) and nothing whole:
``init`` draws the layers one at a time as one device draws them and
keeps each leaf's block before drawing the next layer, ``load_params``
cuts each leaf of a whole tree (a host tree is cut on the host),
``params`` is the blocks and ``full_params`` gathers them. Every rank
calls the methods with the same global batch; each computes its rows
(batch over DP, sequence over 'model' where each divides) and the
outputs come back whole on every rank (``hidden_seq``, logits) or as
this rank's cache shards (``prefill``, ``init_cache``; ``full_cache``
gathers them). Each block is gathered whole at its use, cast first and
gathered second: in training (``params=`` the blocks) under autograd,
in serving from the cast copy, which is held as blocks too (the
reference's layout: GSPMD gathers a sharded weight at its use).
``seq_parallel_attn`` is the reference's switch; the port runs the
sequence-parallel island either way (GSPMD computes the same function,
and the tests hold both settings to the reference).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.core import prng
from repro_torch.core.solver import _device
from repro_torch.sharding import layout as lo
from repro_torch.sharding.layout import Layout

from . import attention as attn
from . import encdec
from . import transformer as tfm
from .common import compute_dtype


def _module(tree: dict) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree(m: nn.Module) -> dict:
    out: dict[str, Any] = dict(m.named_parameters(recurse=False))
    out.update({k: _tree(c) for k, c in m.named_children()})
    return out


def _flat(tree: dict) -> dict:
    """{leaf path: leaf}, paths as the reference's flattener names them."""
    names, leaves, _ = _tree_flatten_with_names(tree)
    return dict(zip(names, leaves))


def _detached(tree: dict) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def _init_tree(key, cfg, keep=tfm._whole) -> dict:
    if cfg.enc_dec:
        return encdec.init_encdec(key, cfg, keep=keep)
    return tfm.init_decoder(key, cfg, keep=keep)


def param_shapes(cfg) -> dict:
    """{leaf path: shape} of the model's parameters, named as the
    reference's ``tree_flatten_with_path`` joined by "/" (kept a
    config). Drawn on the meta device for one period of layers (one
    encoder and one decoder layer), the stacked leaves' layer dim then
    set to the config's count: shapes only, a fraction of a second where
    the whole stack takes seconds."""
    return dict(_param_shapes(cfg))


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg) -> dict:
    one = dataclasses.replace(cfg, n_layers=cfg.layer_period,
                              **({"n_enc_layers": 1} if cfg.enc_dec else {}))
    tree = _init_tree(prng.PRNGKey(0, device="meta"), one)
    lead = {"layers": cfg.n_layers // cfg.layer_period,
            "enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
    out = {}
    for k, v in _flat(tree).items():
        top = k.split("/")[0]
        out[k] = ((lead[top],) + tuple(v.shape)[1:] if top in lead
                  else tuple(v.shape))
    return out


class Model(nn.Module):
    def __init__(self, cfg, device=None, *, ctx=None, q_chunk: int = 1024,
                 kv_chunk: int = 1024, ssm_chunk: int = 256,
                 skip_masked_blocks: bool = False,
                 remat_policy: str = "nothing", cast_at_use: bool = False,
                 seq_parallel_attn: bool = False):
        super().__init__()
        if remat_policy not in tfm.REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{tfm.REMAT_POLICIES}")
        self.cfg = cfg
        self.device = _device(device, "the model")
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        self.ssm_chunk = ssm_chunk
        self.skip_masked_blocks = skip_masked_blocks
        self.cast_at_use = cast_at_use
        self.remat_policy = remat_policy
        self.seq_parallel_attn = seq_parallel_attn
        self.ctx = ctx
        self.layout = (Layout(ctx, param_shapes(cfg))
                       if ctx is not None and ctx.mesh is not None else None)
        if self.layout is not None and \
                ctx.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {ctx.mesh.device_type!r} "
                             f"devices and the model on {self.device}; "
                             "pass a matching device=")
        self.weights: nn.Module | None = None
        self._compute: dict | None = None
        self._cache_shape: tuple[int, int] | None = None
        # float32 products stay float32 (TF32 keeps ~3 decimal digits);
        # both flags are process-wide in PyTorch.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------- params
    def init(self, seed_or_key=0) -> dict:
        """Draw the reference's parameters for this seed (an int) or key
        (a (2,) key of ``core.prng``), install them and return them."""
        if isinstance(seed_or_key, int):
            key = prng.PRNGKey(seed_or_key, device=self.device)
        else:
            key = seed_or_key.to(self.device)
        if self.layout is None:
            self.load_params(_init_tree(key, self.cfg), _consume=True)
        else:       # each layer's blocks kept before the next is drawn
            self.use_params(_init_tree(key, self.cfg, self.layout.keep))
        return self.params

    def load_params(self, tree: dict, *, _consume: bool = False) -> None:
        """Install a parameter tree (the reference's structure, float32;
        on a mesh this rank's blocks are kept)."""
        want, got = param_shapes(self.cfg), _flat(tree)
        if set(want) != set(got):
            missing, extra = set(want) - set(got), set(got) - set(want)
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(missing)}, unexpected {sorted(extra)}")
        bad = [k for k in want if tuple(got[k].shape) != want[k]]
        if bad:
            raise ValueError(f"parameter shapes differ at {bad}")
        del got

        def place(t, path=""):
            if isinstance(t, dict):
                return {k: place(t.pop(k) if _consume else t[k],
                                 f"{path}/{k}" if path else k)
                        for k in list(t)}
            if self.layout is not None:     # only the block moves
                t = self.layout.keep(path, t, device=self.device)
            return torch.as_tensor(t).to(self.device, torch.float32)
        self.use_params(place(tree))

    def use_params(self, tree: dict) -> None:
        """Adopt the tensors of a parameter tree (float32, on the model's
        device, the reference's structure; on a mesh this rank's blocks)
        as the model's parameters, without a copy; the cast copy is made
        again on its next use."""
        self.weights = _module(tree)
        self._compute = None

    def shard(self, tree: dict) -> dict:
        """This rank's blocks of a whole tree (the tree off the mesh)."""
        return tree if self.layout is None else self.layout.shard_tree(tree)

    def full(self, tree: dict) -> dict:
        """A tree of this rank's blocks gathered whole (the tree off the
        mesh)."""
        return tree if self.layout is None else self.layout.full_tree(tree)

    def place(self, batch: dict) -> dict:
        """This rank's data-parallel rows of a global batch, as
        ``ShardedBatcher(mesh=)`` places them (the batch off the mesh);
        the batch must divide over DP, as the reference's placement
        must."""
        if self.layout is None:
            return batch
        lay = self.layout
        i, n = lay.index(lay.dp), lay.size(lay.dp)
        out = {}
        for k, v in batch.items():
            x = torch.as_tensor(v)
            axis = 1 if k == "positions" else 0
            if x.shape[axis] % n:
                raise ValueError(f"batch entry {k!r} of {x.shape[axis]} rows "
                                 f"does not divide over {n} data shards")
            m = x.shape[axis] // n
            out[k] = x.narrow(axis, i * m, m)
        return out

    @property
    def full_params(self) -> dict:
        """The whole float32 parameters (gathered on a mesh)."""
        return self.full(_detached(self.params))

    @property
    def params(self) -> dict:
        """The float32 master parameters, the reference's tree."""
        if self.weights is None:
            raise RuntimeError("no parameters: call init or load_params")
        return _tree(self.weights)

    @property
    def compute_params(self) -> dict:
        """The parameters in the compute dtype (the float32 leaves left
        float32; on a mesh this rank's blocks); under ``cast_at_use`` the
        float32 masters themselves."""
        if self.cast_at_use:
            return self.params
        if self._compute is None:
            self._compute = tfm.cast_tree(_detached(self.params),
                                          compute_dtype(self.cfg))
        return self._compute

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------- embed
    def _params(self, params):
        return self.compute_params if params is None else params

    def _rows(self, B: int, S: int, placed: bool = False):
        """This call's layout on the mesh (None off it). ``placed``: the
        batch holds this rank's data-parallel rows already (as
        ``ShardedBatcher(mesh=)`` places them), B of them."""
        if self.layout is None:
            return None
        if placed:
            B *= self.layout.size(self.layout.dp)
        return self.layout.rows(B, S, gather_params=True)

    def _own(self, x, rows, placed: bool, bdim: int = 0, sdim: int = 1):
        """This rank's rows of a batch entry (all of it off the mesh):
        the layout point, ``ShardingCtx.constrain`` with the batch over
        DP (unless ``placed``) and the sequence over 'model'."""
        x = torch.as_tensor(x).to(self.device)
        if rows is None:
            return x
        wanted = [None] * x.dim()
        if not placed:
            wanted[bdim] = self.ctx.dp_axes
        if sdim is not None:
            wanted[sdim] = self.ctx.tp_axis
        return self.ctx.constrain(x, *wanted)

    def _embed_in(self, batch, dtype, params=None, rows=None,
                  placed=False):
        """The input states and their positions: the VLM's ``embeds`` and
        (3, B, S) ``positions``, else the embedded ``tokens`` and
        0 .. S - 1 (this rank's rows of both on a mesh)."""
        if self.cfg.family == "vlm":
            h = self._own(batch["embeds"], rows, placed).to(dtype)
            positions = self._own(batch["positions"], rows, placed, 1,
                                  2).long()
            return h, positions
        tokens = self._own(batch["tokens"], rows, placed)
        h = self._embed_tokens(tokens, dtype, params, rows)
        B, S = h.shape[:2]
        s0 = 0 if rows is None else rows.s0
        positions = (s0 + torch.arange(S, device=self.device)).expand(B, S)
        return h, positions

    def _embed_tokens(self, tokens, dtype, params=None, rows=None):
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        p = self._params(params)
        if rows is not None:
            p = {"embed": {"table": rows.leaf(p["embed"]["table"],
                                              "embed/table")}}
        return tfm.embed_tokens(self.cfg, p, tokens, dtype)

    def _memory(self, batch, dtype, params, cast, rows=None, placed=False):
        """The encoder's output for the batch's ``frames`` (on a mesh this
        rank's batch rows, whole over the frames)."""
        enc = None if rows is None else self.layout.rows(
            rows.B, self.cfg.enc_seq, gather_params=True)
        frames = self._own(batch["frames"], enc, placed).to(dtype)
        return encdec.encode(self.cfg, self._params(params), frames,
                             cast=cast, rows=enc)

    def _chunks(self) -> dict:
        return dict(q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                    ssm_chunk=self.ssm_chunk,
                    skip_masked_blocks=self.skip_masked_blocks)

    def _serve_cast(self):
        """The cast serving applies at each block's use (None: the
        weights are the cast copy already)."""
        return compute_dtype(self.cfg) if self.cast_at_use else None

    # ---------------------------------------------------------- sequence
    def hidden_seq(self, batch, *, params: dict | None = None,
                   remat: bool = False) -> torch.Tensor:
        """The final hidden states. Without ``params`` the model's own
        weights (the cast copy); with ``params`` (float32 masters, the
        reference's tree) the training forward: cast inside the graph,
        each period (each decoder block of the encoder-decoder)
        checkpointed under ``remat`` by ``remat_policy`` (the
        encoder-decoder's by 'nothing', as the reference's)."""
        h, rows = self.hidden_rows(batch, params=params, remat=remat)
        return h if rows is None else rows.gather_rows(h)

    def _batch_shape(self, batch) -> tuple[int, int]:
        if self.cfg.family == "vlm":
            return tuple(batch["embeds"].shape[:2])
        return tuple(batch["tokens"].shape)

    def hidden_rows(self, batch, *, params: dict | None = None,
                    remat: bool = False, placed: bool = False):
        """(final hidden states, layout): ``hidden_seq`` before its
        gather, this rank's rows on a mesh (layout None off it).
        ``placed``: the batch holds this rank's data-parallel rows."""
        dtype = compute_dtype(self.cfg)
        cast = self._serve_cast() if params is None else dtype
        rows = self._rows(*self._batch_shape(batch), placed)
        if self.cfg.enc_dec:
            memory = self._memory(batch, dtype, params, cast, rows, placed)
            tok = self._embed_tokens(self._own(batch["tokens"], rows, placed),
                                     dtype, params, rows)
            return encdec.decode_seq(
                self.cfg, self._params(params), tok, memory,
                remat=remat and params is not None, q_chunk=self.q_chunk,
                kv_chunk=self.kv_chunk, cast=cast, rows=rows), rows
        h, positions = self._embed_in(batch, dtype, params, rows, placed)
        if params is None:
            return tfm.forward_seq(self.cfg, self.compute_params, h,
                                   positions, cast=cast, rows=rows,
                                   **self._chunks()), rows
        return tfm.forward_seq(self.cfg, params, h, positions, remat=remat,
                               remat_policy=self.remat_policy, cast=cast,
                               rows=rows, **self._chunks()), rows

    def unembed(self, params: dict | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """The (V, D) output matrix (the tied table where tied), float32
        or cast to ``dtype``. On a mesh it is gathered whole, cast first
        (under autograd when ``params`` are the blocks in training)."""
        w = tfm.unembed_matrix(self.cfg, self.params if params is None
                               else params)
        if dtype is not None:
            w = w.to(dtype)
        if self.layout is None:
            return w
        name = "embed/table" if self.cfg.tie_embeddings else "unembed"
        return self.layout.gather_param(w, self.layout.specs[name])

    def _unembed_c(self) -> torch.Tensor:
        return self.unembed(self.compute_params, compute_dtype(self.cfg))

    def logits_seq(self, batch) -> torch.Tensor:
        h = self.hidden_seq(batch)
        return h @ self._unembed_c().T

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16):
        """Zero caches for ``batch`` sequences of ``cache_len`` (on a mesh
        this rank's shards)."""
        rows = self._rows(batch, 1)
        self._cache_shape = (batch, cache_len)
        if self.cfg.enc_dec:
            B = batch if rows is None else rows.B_l
            return encdec.init_dec_cache(
                self.cfg, B, self._cache_rows(rows, cache_len, True), dtype,
                self.device)
        return tfm.init_cache(self.cfg, batch, cache_len, dtype, self.device,
                              rows=rows)

    @staticmethod
    def _cache_rows(rows, cache_len: int, two_d: bool) -> int:
        """A cache's local length: ``cache_len`` over its sequence axes."""
        axes = attn.cache_seq_axes(rows, cache_len, two_d=two_d)
        return cache_len // (rows.lay.size(axes) if axes else 1)

    def prefill(self, batch, cache_len: int):
        """(last-token logits (B, V), caches): every rank gets the logits
        whole and its shard of the caches."""
        dtype, cast = compute_dtype(self.cfg), self._serve_cast()
        B, S = self._batch_shape(batch)
        rows = self._rows(B, S)
        self._cache_shape = (B, cache_len)
        if self.cfg.enc_dec:
            memory = self._memory(batch, dtype, None, cast, rows)
            tok = self._embed_tokens(self._own(batch["tokens"], rows, False),
                                     dtype, rows=rows)
            h, caches = encdec.prefill(self.cfg, self.compute_params, tok,
                                       memory, cache_len,
                                       q_chunk=self.q_chunk,
                                       kv_chunk=self.kv_chunk, cast=cast,
                                       rows=rows)
        else:
            h, positions = self._embed_in(batch, dtype, rows=rows)
            h, caches = tfm.forward_prefill(self.cfg, self.compute_params,
                                            h, positions, cache_len,
                                            cast=cast, rows=rows,
                                            **self._chunks())
        last = h[:, -1, :]
        if rows is not None:
            if rows.s_split:     # the last position is on the last rank
                lay = rows.lay
                mine = rows.s0 + rows.S_l == S
                last = lo.psum(last if mine else torch.zeros_like(last),
                               lay.axes(lay.tp))
            last = rows.gather_batch(last)
        return last @ self._unembed_c().T, caches

    def decode(self, tokens, pos: int, caches):
        """tokens: (B, 1) ints; pos: the index the tokens take. On a mesh
        the caches are this model's last ``prefill`` / ``init_cache``
        shards and the logits come back whole."""
        tokens = torch.as_tensor(tokens)
        rows = self._rows(tokens.shape[0], 1)
        cache_len = 0
        if rows is not None:
            if self._cache_shape is None or \
                    self._cache_shape[0] != tokens.shape[0]:
                raise ValueError("decode on a mesh takes the caches of this "
                                 "model's prefill or init_cache for the "
                                 "same batch")
            cache_len = self._cache_shape[1]
        h = self._embed_tokens(self._own(tokens, rows, False, sdim=None),
                               compute_dtype(self.cfg), rows=rows)
        step = encdec.decode_step if self.cfg.enc_dec else tfm.forward_decode
        h, caches = step(self.cfg, self.compute_params, h, int(pos), caches,
                         cast=self._serve_cast(), rows=rows,
                         cache_len=cache_len)
        logits = h @ self._unembed_c().T
        return (logits if rows is None else rows.gather_batch(logits)), \
            caches

    def full_cache(self, caches):
        """The caches of this model's last ``prefill`` / ``init_cache``,
        gathered to the one-device layout (the caches off the mesh)."""
        if self.layout is None:
            return caches
        B, cache_len = self._cache_shape
        rows = self._rows(B, 1)
        lay = rows.lay

        def whole(x, axes):             # a (periods, B, S, ...) leaf
            x = rows.gather_batch(x, 1)
            return lo.gather(x, 2, lay.axes(axes)) if axes else x

        with torch.no_grad():
            if self.cfg.enc_dec:
                axes = attn.cache_seq_axes(rows, cache_len)
                return {k: whole(v, axes if k in ("k", "v") else ())
                        for k, v in caches.items()}
            out = {}
            for j in range(self.cfg.layer_period):
                mixer, _ = tfm.block_kind(self.cfg, j)
                axes = (attn.cache_seq_axes(rows, cache_len,
                                            two_d=mixer == "gqa")
                        if mixer in ("gqa", "mla") else ())
                out[f"pos{j}"] = tfm._tree_map(lambda x: whole(x, axes),
                                               caches[f"pos{j}"])
            return out


def build_model(cfg, ctx=None, device=None, **kw) -> Model:
    """The model of ``cfg``; ``ctx`` a ``ShardingCtx`` puts it on a mesh
    (the reference's signature: ``build_model(cfg, ctx, **kw)``). A
    device in ``ctx``'s place (``build_model(cfg, "cpu")``, the one-device
    form) is taken as the device."""
    from repro_torch.sharding import ShardingCtx
    if ctx is not None and not isinstance(ctx, ShardingCtx):
        if device is not None:
            raise TypeError("build_model got a device twice")
        ctx, device = None, ctx
    return Model(cfg, device, ctx=ctx, **kw)
