"""The reference's training steps, plain PyTorch, for the first steps of a
training cell.

The reference solver's step: ``loss = lambda_rec * mean|x - dec| +
lambda_kl * KL``, backward, ``clip_grad_norm_`` to ``grad_norm``, then
``torch.optim.Adam`` with L2 weight decay and ``amsgrad``. The batch of
step ``i`` is drawn as the program under test documents its device
sampler (train/step.py ``make_device_data_train_step``): one generator on
the device seeded with ``step_seed(seed, i)``, ``batch_size`` 62-bit
integers modulo the number of segment starts, the rows gathered from the
packed corpus, then the VAE's normal draw from the same generator. That
rule is written out here again; nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .model import Net, Params


def step_seed(seed: int, iteration: int) -> int:
    ss = np.random.SeedSequence([seed + 1, iteration])
    return int(ss.generate_state(1, np.uint64)[0])


def kl_lambda(iteration: int, lambda_kl: float, annealing_iters: int) -> float:
    return lambda_kl * min(1.0, (iteration + 1) / annealing_iters)


def draw_batch(packed: torch.Tensor, starts: torch.Tensor, seg: int, batch: int,
               gen: torch.Generator) -> torch.Tensor:
    r = torch.randint(0, 2**62, (batch,), generator=gen, device=packed.device, dtype=torch.int64)
    s = starts[torch.remainder(r, starts.shape[0])]
    return packed[s[:, None] + torch.arange(seg, device=packed.device)[None, :]]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def reference_steps(cfg: dict, params0: Params, packed: torch.Tensor, starts: torch.Tensor,
                    seed: int, n_steps: int = 3) -> dict:
    """``n_steps`` reference steps from ``params0`` (not modified), in f32
    with TF32 off. Returns the losses, each leaf's norm of the first
    gradient as Adam holds it after one step (its first moment over
    ``1 - beta1``: the clipped gradient plus the weight decay term), and each
    leaf's norm of the parameters' change after ``n_steps`` steps."""
    dl, opt_cfg = cfg["data_loader"], cfg["optimizer"]
    lam = cfg["lambda"]
    params = {k: v.detach().clone() for k, v in params0.items()}
    names = [k for k in params if not k.endswith((".weight_u", ".weight_v"))]
    leaves = [params[k].requires_grad_(True) for k in names]
    opt = torch.optim.Adam(
        leaves, lr=opt_cfg["lr"], betas=(opt_cfg["beta1"], opt_cfg["beta2"]), eps=1e-8,
        weight_decay=opt_cfg["weight_decay"], amsgrad=opt_cfg["amsgrad"], foreach=False,
    )
    gen = torch.Generator(device=packed.device)
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i in range(n_steps):
            gen.manual_seed(step_seed(seed, i))
            x = draw_batch(packed, starts, dl["segment_size"], dl["batch_size"], gen).float()
            net = Net(cfg, params)
            xc = x.transpose(1, 2)
            emb = net.speaker_encoder(xc)
            mu, log_sigma = net.content_encoder(xc)
            eps = torch.randn(log_sigma.shape, generator=gen, device=x.device)
            dec = net.decoder(mu + torch.exp(log_sigma / 2) * eps, emb)
            loss_rec = (xc - dec).abs().mean()
            loss_kl = 0.5 * (torch.exp(log_sigma) + mu ** 2 - 1 - log_sigma).mean()
            kl = kl_lambda(i, lam["lambda_kl"], cfg["annealing_iters"])
            loss = lam["lambda_rec"] * loss_rec + kl * loss_kl
            opt.zero_grad(set_to_none=True)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(leaves, max_norm=opt_cfg["grad_norm"])
            opt.step()
            with torch.no_grad():
                for name, u in net.new_u.items():
                    params[f"{name}.weight_u"] = u
            losses.append(float(loss.detach()))
            if i == 0:
                b1 = opt_cfg["beta1"]
                grad1 = leaf_norms({n: opt.state[p]["exp_avg"] / (1 - b1) for n, p in zip(names, leaves)})
        change = leaf_norms({n: params[n].detach() - params0[n] for n in names})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return {"losses": losses, "grad1": grad1, "change": change}


def compare_steps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training cell is judged by:

    - ``loss1_gap``: |loss - loss_ref| / |loss_ref| of the first step, the
      forward at the weights both sides start from;
    - ``loss23_gap``: the largest of the same over the later steps, which
      also carry the first updates;
    - ``grad_gap``: over the leaves, the gap between the program's and the
      reference's norm of the first gradient, over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``change_gap``: the same for the parameters' change after the steps,
      over the leaves whose reference gradient is at least a thousandth of
      the median leaf's (a leaf below that, such as a bias that an instance
      norm removes, moves under Adam by round-off alone).
    """
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]

    def worst(key: str, keep) -> float:
        r, p = ref[key], prog[key]
        med = float(np.median([r[k] for k in keep]))
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)

    g = ref["grad1"]
    g_med = float(np.median(list(g.values())))
    moving = [k for k in g if g[k] >= 1e-3 * g_med]
    return {
        "loss1_gap": gaps[0],
        "loss23_gap": max(gaps[1:]),
        "grad_gap": worst("grad1", list(g)),
        "change_gap": worst("change", moving),
    }
