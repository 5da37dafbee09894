"""Training step: mixed-precision forward and backward, then AdamW (the
counterpart of ``src/repro/train/train_step.py``).

The train state is ``{"params": LM, "opt": {"mu", "nu", "count"},
"step"}``: the model holds the float32 masters, the moments mirror them
(:mod:`.optimizer`), ``step`` is an int32 scalar tensor.  Once a step,
every leaf with two or more dimensions on the reference's tree (every
per-layer leaf, which the reference stacks, and the matrices) is cast
to ``cfg.dtype``, as the reference's ``compute_params`` are; the forward
runs on those tensors (:func:`repro_torch.models.lm.loss_fn` with
``params``) and the gradient is taken with respect to them, so the
matrices' gradients arrive in the compute dtype and the norm and the
update cast them up.  Optional gradient compression
(:mod:`.compression`) sits between the backward and the update.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import build_model, loss_fn
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import reference_ndim
from repro_torch.models.lm import LM

from .compression import compress_decompress
from .optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # grad accumulation inside the step
    compression: str = "none"      # none | int8 | topk (see compression.py)
    #: the reference's ZeRO-1 gather of the compute weights over its mesh;
    #: the port runs on one device and has no mesh, where the reference's
    #: does nothing either
    zero1_compute_params: bool = False


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device=None,
                     model: LM | None = None) -> dict:
    """A fresh train state: ``model``, or :func:`build_model`'s seeded
    random weights on ``device`` (the card unless named), zero moments,
    step 0."""
    if model is None:
        model = build_model(cfg, seed=seed, device=device)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.embed.device)}


def abstract_train_state(cfg: ModelConfig) -> dict:
    """The train state's shapes and dtypes on the meta device (no
    storage)."""
    return init_train_state(cfg, device="meta")


def compute_params(model: LM) -> dict[str, torch.Tensor]:
    """The step's compute tensors, each requiring a gradient: the masters
    cast to ``cfg.dtype`` where the reference's leaf has two or more
    dimensions, else the master itself (detached)."""
    dtype = getattr(torch, model.cfg.dtype)
    return {name: (p.detach().to(dtype) if reference_ndim(name, p) >= 2
                   else p.detach()).requires_grad_()
            for name, p in model.named_parameters()}


def _split(batch: dict, M: int, i: int) -> dict:
    """Microbatch ``i`` of ``M``: rows i·B/M .. (i+1)·B/M of each leaf."""
    return {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: ``batch``
    holds ``tokens`` and ``labels`` (B, S) on the model's device; the
    state is updated in place and handed back; the metrics ``loss``,
    ``grad_norm`` and ``lr`` are float32 scalar tensors.  With
    ``microbatches`` M > 1 the batch is split M ways and the loss and the
    float32 sums of the gradients are divided by M."""
    tcfg = tcfg or TrainConfig()

    def compute_grads(model: LM, batch: dict):
        compute = compute_params(model)
        names = list(compute)
        leaves = [compute[n] for n in names]
        M = tcfg.microbatches
        if M <= 1:
            loss = loss_fn(model, batch, compute)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=model.embed.device)
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in model.named_parameters()}
        for i in range(M):
            loss = loss_fn(model, _split(batch, M, i), compute)
            grads = torch.autograd.grad(loss, leaves)
            loss_acc = loss_acc + loss.detach()
            for n, g in zip(names, grads):
                acc[n] = acc[n] + g.float()
        inv = 1.0 / M
        return loss_acc * inv, {n: g * inv for n, g in acc.items()}

    def train_step(state: dict, batch: dict):
        model = state["params"]
        if model.cfg != cfg:
            raise ValueError(f"the state's model is {model.cfg.name!r} as "
                             f"configured otherwise than this step's "
                             f"{cfg.name!r}")
        loss, grads = compute_grads(model, batch)
        if tcfg.compression != "none":
            grads = compress_decompress(grads, method=tcfg.compression)
        _, opt, metrics = adamw_update(tcfg.optimizer, grads, state["opt"],
                                       dict(model.named_parameters()))
        metrics["loss"] = loss
        state["opt"] = opt
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step
