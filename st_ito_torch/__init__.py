"""st_ito_torch — the PyTorch/CUDA port of ``st_ito_tpu`` for one NVIDIA H100.

The package mirrors ``st_ito_tpu``'s layout and public names:

- ``chain``   effect-chain specs, the effect registry (``chain_from_json``,
              ``chain_preset``), the population renderer
              ``build_batched_render_fn`` and the per-candidate renderer
              ``build_render_fn``.
- ``ops``     the effects' DSP in plain PyTorch, the fused-LTI group around
              ``torch.fft`` or K10 (``ops/lti.py``), the FFT resampler and the
              hand-written CUDA kernels' wrappers (``ops/kernels/``); the
              CUDA sources live in ``st_ito_torch/csrc/``.
- ``models``  the AFx-Rep Cnn14 as an ``nn.Module``, its weight converter and
              ``load_param_model`` / ``get_param_embeds``.
- ``ito``     the host and device-resident CMA-ES, ``run_es`` and gradient
              ITO (``run_autodiff``).
- ``cli``     the style-transfer CLI (``python -m st_ito_torch.cli.run_optim``),
              the evaluation CLIs ``eval_psm``, ``eval_sweep`` and
              ``effect_info``.
- ``eval``    the metric registry and the recovery evaluations (synthetic,
              sweep, case study, PSM) with their figures.
- ``proc``    the 51-parameter differentiable processor of gradient ITO.
- ``train``   the pretext ParameterEstimator and the StyleTransferSystem
              (``torch.optim``), with the training CLI
              ``python -m st_ito_torch.cli.train``.
- ``data``    preset banks, dataset synthesis on the card's kernels, the
              shard and tar-of-FLAC datasets (``native/io.py`` binds the
              loader's C++ engine); ``augment`` the paired transforms.

It imports torch, numpy and the standard library only. Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
