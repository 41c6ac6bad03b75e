"""PyTorch + CUDA port of the PEMSVM package ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package is held against
it by the ``tests/test_torch_*.py`` suite and imports neither JAX nor
anything under ``repro``. Importing it needs only CPU PyTorch: the CUDA
kernels are compiled with ``nvcc`` on first use (``kernels/_build.py``).

Ported so far:

* every option string of the paper through ``PEMSVM(SVMConfig...)``:
  LIN-EM-CLS, LIN-MC-CLS, LIN-EM-SVR, LIN-MC-SVR, LIN-EM-MLT, LIN-MC-MLT
  and the exact-Gram KRN-EM-CLS and KRN-MC-CLS, and through
  ``NystromSVM`` KRN-{EM,MC}-{CLS,SVR,MLT}; the MC noise sources 'host',
  'fused_predraw' and 'fused', and ``n_chains``;
* the ``scan``, ``loop`` and ``stream`` drivers: ``fit``, and for the
  out-of-core stream driver also ``fit_chunks`` and ``fit_libsvm``
  (chunks copied to the card from page-locked memory on a side stream,
  ``data/pipeline.py``; libsvm text IO, ``data/libsvm.py``);
* warm-started stream generations: ``fit(warm_start=...)`` with
  ``decay`` or a hard-expiry ``window`` of generations
  (``core/stats.py``'s ``StatsWindow``), and ``NystromSVM.fit_libsvm``
  with reservoir landmarks (``data.reservoir_rows``);
* serving (``serving/``): ``export_servable`` / ``scorer``, bucketed
  score cells bitwise across buckets, ``WeightPager``, ``ServeLoop``
  (``launch/serve.py --mode svm``);
* one device, or a ``torch.distributed`` DeviceMesh (data-parallel, or
  2-D with ``k_shard_axis``);
* the slice of ``jax.random`` the samplers need (``core/prng.py``);
* the LM substrate (``models/``, ``training/``, ``serving/``): the dense
  and MoE GQA decoders served (prefill, KV-cache decode, sampling) and
  trained (AdamW, chunked cross-entropy, remat, micro-batching;
  ``launch/train.py``), and ``MaxMarginHead`` over their features;
* all eight kernels of the reference, hand-written in CUDA for sm_90a
  (``csrc/``): ``fused_stats`` (em_hinge, mc_hinge, em_svr, mc_svr; noise
  operands or the in-kernel counter RNG; multichain; column windows),
  ``fused_estep``, ``syrk_tri``, ``weighted_gram``, ``rbf_gram``,
  ``nystrom_phi``, ``nystrom_score`` and ``nystrom_fused_stats``;
* the paper's baselines (``baselines/``: Pegasos, and DCD with its sweep
  one CUDA launch, ``csrc/dcd.cu``), the PEMSVM cells of Table 3
  (``launch/svm_cell.py``), and the dry run of every cell on the meta
  device with its flops, bytes and collectives counted
  (``launch/{cost,dryrun,sweep}.py``).

ROADMAP.md lists what is still to come.
"""
from .core import NystromSVM, PEMSVM, SVMConfig, lam_from_C  # noqa: F401
