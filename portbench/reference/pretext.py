"""Plain AFx-Rep pretext training (Steinmetz et al., ST-ITO; the
reference's ``methods/param.py``): the reference for the training cells.

- The loader's batches, read again from the shard files: a frozen reading
  of ``NpzShardDataset``'s draws (numpy ``default_rng(seed)``: the shard
  order each epoch; for each shard the row permutation, the input gains,
  the output gains, the joint left/right flips; no crop where clips are as
  long as the batch's), in ``batches``.
- Cnn14 in train mode (``cnn14.py``'s blocks with batch-statistics
  BatchNorm), SpecAugment (two time stripes of at most 64 frames, two
  frequency stripes of at most 8 bins) and dropout at keep 0.8 after every
  block, drawn from a ``torch.Generator`` on the card seeded as the run's:
  for each forward the stripes' starts then widths, time before frequency,
  then each block's keep mask; the outputs' forward before the inputs'.
- Concat mode with L2: [in_mid, out_mid, in_side, out_side]; the instance
  head MLP (fc, ReLU, fc) with cross-entropy, the preset head on
  [instance logits, feats] with cross-entropy; the loss their sum.
- AdamW (decoupled decay scaled by lr, bias-corrected moments, eps added
  to the corrected root), written out.

``steps`` runs the first steps in the dtype of its parameters (float64 for
the reference; the control runs float32 with TF32 on)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import cnn14

KEEP = 0.8
TIME_STRIPES = (64, 2)  # (most frames, stripes)
FREQ_STRIPES = (8, 2)  # (most mel bins, stripes)


def head_specs(cfg: dict) -> list:
    d = cfg["encoder"]["embed_dim"] * 4
    specs = []
    for name, din, dout in (("instance_estimator", d, cfg["num_instances"]),
                            ("preset_estimator", d + cfg["num_instances"],
                             cfg["num_presets"])):
        specs += [(f"{name}.fc1.weight", (2 * din, din), "linear"),
                  (f"{name}.fc1.bias", (2 * din,), "bias"),
                  (f"{name}.fc2.weight", (dout, 2 * din), "linear"),
                  (f"{name}.fc2.bias", (dout,), "bias")]
    return specs


def param_specs(cfg: dict) -> list:
    """The estimator's tensors: the encoder's (prefixed) and the heads'."""
    return ([(f"encoder.{n}", s, k) for n, s, k in
             cnn14.param_specs(cfg["encoder"])] + head_specs(cfg))


def is_trained(name: str) -> bool:
    return not (name.endswith("running_mean") or name.endswith("running_var")
                or name.endswith("num_batches_tracked"))


def batches(paths: list[str], seed: int, batch_size: int, length: int,
            count: int, device) -> list[dict]:
    """The first ``count`` batches the shard loader yields for ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        for pi in rng.permutation(len(paths)):
            with np.load(paths[pi]) as d:
                inputs, outputs = d["inputs"], d["outputs"]
                labels = {k: d[k] for k in ("instance_index", "preset_index",
                                            "tar_index")}
            n, chs, T = inputs.shape
            if T != length or n % batch_size:
                raise ValueError("shards of whole batches of clips as long "
                                 "as the batch's")
            perm = rng.permutation(n)
            gi = (10.0 ** (-rng.random(n) * 32.0 / 20.0)).astype(np.float32)
            go = (10.0 ** (-rng.random(n) * 32.0 / 20.0)).astype(np.float32)
            flips = rng.random(n) < 0.5

            def side(a, g):
                y = a[perm].astype(np.float32) * g[:, None, None]
                y[flips] = y[flips][:, ::-1, :]
                return y

            x, y = side(inputs, gi), side(outputs, go)
            for s in range(0, n, batch_size):
                sl = slice(s, s + batch_size)
                out.append({
                    "inputs": torch.as_tensor(x[sl], device=device),
                    "outputs": torch.as_tensor(y[sl], device=device),
                    **{k: torch.as_tensor(v[perm][sl].astype(np.int64),
                                          device=device)
                       for k, v in labels.items()}})
                if len(out) == count:
                    return out
    return out


def spec_augment(h, gen):
    N, _, frames, bins = h.shape
    mask = torch.ones_like(h)
    for size, (width, stripes), axis in ((frames, TIME_STRIPES, 2),
                                         (bins, FREQ_STRIPES, 3)):
        idx = torch.arange(size, device=h.device)
        for _ in range(stripes):
            starts = torch.randint(0, max(size - width, 1), (N,),
                                   generator=gen, device=h.device)
            widths = torch.randint(0, width + 1, (N,), generator=gen,
                                   device=h.device)
            inside = (idx[None] >= starts[:, None]) & (
                idx[None] < (starts + widths)[:, None])
            shape = (N, 1, size, 1) if axis == 2 else (N, 1, 1, size)
            mask = mask * (~inside).reshape(shape).to(h.dtype)
    return h * mask


def train_bn(params):
    def bn(h, prefix):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = h.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        w = params[f"{prefix}.weight"][None, :, None, None]
        b = params[f"{prefix}.bias"][None, :, None, None]
        return (h - mean) / torch.sqrt(var + cnn14.BN_EPS) * w + b

    return bn


def encode(params: dict, x: torch.Tensor, enc: dict, gen):
    """Train-mode (mid, side) of x (batch, 2, T) with the draws from gen."""
    batch, _, T = x.shape
    enc_params = {k[len("encoder."):]: v for k, v in params.items()
                  if k.startswith("encoder.")}
    h = cnn14.minmax(cnn14.logmel(cnn14.mid_side(x).reshape(batch * 2, T),
                                  enc))
    h = spec_augment(h, gen)

    def dropout(h):
        keep = torch.rand(h.shape, generator=gen, device=h.device) < KEEP
        return torch.where(keep, h / KEEP, torch.zeros_like(h))

    h = cnn14.conv_stack(h, enc_params, enc, train_bn(enc_params),
                         block_hook=dropout)
    return cnn14.heads(h, enc_params, batch)


def mlp(params, name, v):
    h = torch.relu(v @ params[f"{name}.fc1.weight"].T
                   + params[f"{name}.fc1.bias"])
    return h @ params[f"{name}.fc2.weight"].T + params[f"{name}.fc2.bias"]


def loss_fn(params, batch, cfg, gen, rows=None):
    """The step's loss; ``rows`` limits the mean to those rows (a fault
    the readings plant)."""
    enc = cfg["encoder"]
    dtype = params["encoder.conv_block1.conv1.weight"].dtype
    out_mid, out_side = encode(params, batch["outputs"].to(dtype), enc, gen)
    in_mid, in_side = encode(params, batch["inputs"].to(dtype), enc, gen)
    feats = torch.cat([cnn14.l2(in_mid), cnn14.l2(out_mid),
                       cnn14.l2(in_side), cnn14.l2(out_side)], dim=-1)
    logits = mlp(params, "instance_estimator", feats)
    preset = mlp(params, "preset_estimator", torch.cat([logits, feats], -1))
    sel = slice(None) if rows is None else rows
    return (F.cross_entropy(logits[sel], batch["instance_index"][sel])
            + F.cross_entropy(preset[sel], batch["preset_index"][sel]))


@contextlib.contextmanager
def tf32(allowed: bool):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def steps(weights: dict, cfg: dict, data: list[dict], seed: int, device,
          allow_tf32: bool = False, rows=None, alter_label: bool = False
          ) -> dict:
    """len(data) AdamW steps from ``weights``: {"losses": [...],
    "grad1": {name: norm of the first gradient}, "change": {name: norm of
    the parameters' change after the steps}}. ``rows`` and
    ``alter_label`` (the first example's instance label moved by one)
    plant faults."""
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if is_trained(k)}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    lr, wd, b1, b2, eps = cfg["lr"], cfg["weight_decay"], 0.9, 0.999, 1e-8
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, grad1 = [], {}
    with tf32(allow_tf32):
        for t, batch in enumerate(data, start=1):
            if alter_label:
                batch = dict(batch)
                batch["instance_index"] = batch["instance_index"].clone()
                batch["instance_index"][0] = (
                    batch["instance_index"][0] + 1) % cfg["num_instances"]
            loss = loss_fn(params, batch, cfg, gen, rows)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    if t == 1:
                        grad1[k] = float(torch.linalg.vector_norm(g))
                    p.mul_(1.0 - lr * wd)
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (v2[k] / (1.0 - b2 ** t)).sqrt() + eps
                    p.sub_(lr / (1.0 - b1 ** t) * m[k] / denom)
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k]))
              for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}
