"""Samplers: DDPM ancestral and DDIM (port of unet_tpu/diffusion/sampler.py).

DDPM math:
  loop t = T-1 ... 2 (998 model calls for T=1000);
  eps = model(x_t, t);
  mu_t   = (x_t - beta[t-1]/sqrt(1-abar[t-1]) * eps) / sqrt(1-beta[t-1]);
  sigma_t = sqrt((1-abar[t-2])/(1-abar[t-1]) * beta[t-1]);
  x_{t-1} = mu_t + sigma_t * N(0,1)      (noise added at every step).

The JAX package runs the chain as one compiled loop.  Here one step of the
chain is a function of tensors that stay put: the image x, the injected
noise z, a step counter i on the device, and per-step tables on the device
(the timestep and the step's coefficients, float32 from the numpy schedule
tables as the JAX package computes them, indexed by i, which the step
advances).  On a CUDA device that step is captured into a CUDA graph and
the chain is its replays (`utils/graphs.py`: the first step runs eagerly,
the second is captured); on the CPU the same step runs eagerly.  Nothing
is read back until the caller takes the images.

Where the JAX functions take a PRNG key, these take a `torch.Generator` on
the model's device.  The noise of a step is drawn before its replay, outside
the graph, into z (`z.normal_(generator=...)`, the numbers `torch.randn`
draws), so a chain draws the same numbers from the same generator whether
it is captured or not.  The two frameworks draw different numbers, so
parity tests feed `x_init` and `noise`.
"""

from __future__ import annotations

import numpy as np
import torch

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.diffusion.gaussian import GaussianDiffusion
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.utils import graphs


def make_model_fn(cfg: UnetConfig, *, compute_dtype=torch.float32,
                  y=None, guidance_scale: float = 1.0):
    """`model_fn(model, x, t) -> eps` (float32) for the samplers.

    y = None: unconditional.  y = an int or (B,) labels: class-conditional
    eps.  guidance_scale w != 1 additionally applies classifier-free
    guidance, eps = eps_uncond + w * (eps_cond - eps_uncond), computed as ONE
    model call on a doubled batch ([y | null]); w = 1 is the plain
    conditional call and w = 0 the unconditional one."""
    def labels(x):
        if torch.is_tensor(y):
            return y.to(device=x.device, dtype=torch.long).expand(x.shape[0])
        return torch.full((x.shape[0],), int(y), dtype=torch.long,
                          device=x.device)

    def model_fn(model, x, t):
        net = model.to_compute(compute_dtype)
        if y is None:
            return net(x, t).float()
        yy = labels(x)
        if guidance_scale == 0.0:
            yy = torch.full_like(yy, -1)
        if guidance_scale in (0.0, 1.0):
            return net(x, t, yy).float()
        eps_c, eps_u = net(torch.cat([x, x]), torch.cat([t, t]),
                           torch.cat([yy, torch.full_like(yy, -1)])
                           ).float().chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u)
    return model_fn


def _start(model, cfg, generator, batch_size, x_init, rows=None):
    """The chain's start: `x_init`, or a draw from `generator`; with
    `rows`, those rows of it, `batch_size` being the global batch."""
    if x_init is not None:
        x = x_init.to(device=model.device, dtype=torch.float32)
        return (x if rows is None else x[rows]).clone()
    x = torch.randn((batch_size, cfg.image_size, cfg.image_size,
                     cfg.in_channels), generator=generator,
                    device=model.device)
    return x if rows is None else x[rows].contiguous()


def _run_chain(step, z, n, draws, generator, noise, rows=None) -> None:
    """Runs `step` n times (captured and replayed on a CUDA device).  Before
    step k, where `draws[k]`, z gets that step's noise: `noise[k]` when
    given, else a draw from `generator`.  With `rows`, z holds those rows
    of the global batch, and the noise (given or drawn) is the global
    batch's, cut to them."""
    if noise is not None:
        noise = noise.to(device=z.device, dtype=torch.float32)
    whole = None
    if rows is not None and noise is None:  # rows = slice(rank, None, world)
        whole = torch.empty((z.shape[0] * rows.step,) + tuple(z.shape[1:]),
                            dtype=z.dtype, device=z.device)
    chain = graphs.Graph(step, z.device)
    for k in range(n):
        if draws[k]:
            if noise is not None:
                z.copy_(noise[k] if rows is None else noise[k][rows])
            elif whole is not None:
                z.copy_(whole.normal_(generator=generator)[rows])
            else:
                z.normal_(generator=generator)
        chain()


class _StepTables:
    """Per-step tables on the device and the step counter that indexes
    them, both read and advanced on the device: `at(name)` is the (1,)
    entry of the current step, `at.advance()` moves to the next.  (An
    index that is a 0-dim tensor would be read back to the host.)"""

    def __init__(self, device, **columns):
        self.columns = {k: torch.as_tensor(np.asarray(v, np.float32),
                                           device=device)
                        for k, v in columns.items()}
        self.i = torch.zeros((1,), dtype=torch.long, device=device)

    def __call__(self, name: str) -> torch.Tensor:
        return self.columns[name].index_select(0, self.i)

    def advance(self) -> None:
        self.i.add_(1)


def ddpm_tables(diffusion: GaussianDiffusion, n: int) -> dict:
    """The timestep and the coefficients of the ancestral chain's first n
    steps (t = T-1, T-2, ...), float32 numpy columns: the scalars the JAX
    package's loop computes at each step."""
    f32 = np.float32
    t = diffusion.num_timesteps - 1 - np.arange(n)
    beta_t = diffusion.betas[t - 1]
    alpha_t = diffusion.alphas_cumprod[t - 1]
    alpha_t_1 = diffusion.alphas_cumprod[t - 2]
    return dict(
        t=t.astype(f32),
        c_eps=beta_t / np.sqrt(f32(1.0) - alpha_t),
        c_mu=f32(1.0) / np.sqrt(f32(1.0) - beta_t),
        sigma=np.sqrt((f32(1.0) - alpha_t_1) / (f32(1.0) - alpha_t)
                      * beta_t))


@torch.no_grad()
def ddpm_sample(model, cfg: UnetConfig, diffusion: GaussianDiffusion,
                generator=None, *, batch_size: int = 1,
                compute_dtype=torch.float32, x_init=None, num_steps=None,
                model_fn=None, y=None, guidance_scale: float = 1.0,
                noise=None, rows=None):
    """Draw `batch_size` images on the model's device.  Returns (B, H, W, C)
    float32 in [-1, 1]-ish (unclipped).  `num_steps` truncates the chain to
    its first iterations (t = T-1 downward).  `y`/`guidance_scale` select
    class-conditional and classifier-free-guided sampling (see
    make_model_fn); `model_fn` overrides the model call entirely.  `noise`
    (n_steps, B, H, W, C) supplies the per-step injected noise instead of
    drawing it from `generator`, and `x_init` the start: the cross-framework
    parity hooks.  `rows` (a slice `distributed.global_batch` gives) keeps
    those rows of a chain of `batch_size` images: the start and the noise
    are drawn (or given) for all of them (see `make_parallel_sampler`)."""
    T = diffusion.num_timesteps
    net = model.to_compute(compute_dtype)
    x = _start(net, cfg, generator, batch_size, x_init, rows)
    if model_fn is None:
        model_fn = make_model_fn(cfg, compute_dtype=compute_dtype, y=y,
                                 guidance_scale=guidance_scale)
    n = T - 2 if num_steps is None else min(num_steps, T - 2)
    if noise is not None and noise.shape[0] < n:
        raise ValueError(f"noise has {noise.shape[0]} steps, chain needs {n}")
    at = _StepTables(x.device, **ddpm_tables(diffusion, n))
    z = torch.zeros_like(x)

    def step():
        eps = model_fn(net, x, at("t").expand(x.shape[0]))
        x.copy_((x - at("c_eps") * eps) * at("c_mu") + at("sigma") * z)
        at.advance()

    _run_chain(step, z, n, [True] * n, generator, noise, rows)
    return x


def make_sampler(cfg: UnetConfig, diffusion: GaussianDiffusion, *,
                 batch_size: int = 1, compute_dtype=torch.float32,
                 num_steps=None, y=None, guidance_scale: float = 1.0):
    """`sample(model, generator) -> (B, H, W, C)` closure over the DDPM
    chain's settings."""
    return lambda model, generator=None: ddpm_sample(
        model, cfg, diffusion, generator, num_steps=num_steps,
        batch_size=batch_size, compute_dtype=compute_dtype,
        y=y, guidance_scale=guidance_scale)


def ddim_tables(diffusion: GaussianDiffusion, num_steps: int,
                eta: float = 0.0) -> dict:
    """The timesteps and coefficients of a DDIM chain of `num_steps` (fewer
    where the rounded linspace repeats a step), float32 numpy columns: the
    scalars the JAX package's loop computes at each step (see
    `ddim_sample`)."""
    T = diffusion.num_timesteps
    if not 1 <= num_steps <= T - 1:
        raise ValueError(f"num_steps must be in [1, {T - 1}], got {num_steps}")
    f32 = np.float32
    abar = diffusion.alphas_cumprod
    ts = np.unique(np.linspace(1, T - 1, num_steps)
                   .round().astype(np.int64))[::-1]
    a_cur = abar[ts - 1]
    a_prev = np.concatenate([abar[ts[1:] - 1], [1.0]])
    sigma = (eta * np.sqrt((1.0 - a_prev) / (1.0 - a_cur))
             * np.sqrt(np.maximum(1.0 - a_cur / a_prev, 0.0)))
    a_t, a_p, sg = (a.astype(f32) for a in (a_cur, a_prev, sigma))
    return dict(
        t=ts.astype(f32),
        c_eps=np.sqrt(f32(1.0) - a_t),
        c_x0=f32(1.0) / np.sqrt(a_t),
        c_prev=np.sqrt(a_p),
        c_dir=np.sqrt(np.maximum(f32(1.0) - a_p - sg * sg, f32(0.0))),
        sigma=sg)


@torch.no_grad()
def ddim_sample(model, cfg: UnetConfig, diffusion: GaussianDiffusion,
                generator=None, *, num_steps: int = 50, eta: float = 0.0,
                batch_size: int = 1, compute_dtype=torch.float32,
                x_init=None, model_fn=None, y=None,
                guidance_scale: float = 1.0, noise=None, rows=None):
    """DDIM sampler (Song et al. 2020): `num_steps` model calls instead of
    the ancestral chain's T-2.

    Model time t indexes table slot t-1, as in ddpm_sample: an evenly
    spaced descending subsequence T-1 = t_1 > t_2 > ... > t_S >= 1, with

      x0_pred = (x - sqrt(1-abar_t) eps) / sqrt(abar_t)
      sigma   = eta sqrt((1-abar_prev)/(1-abar_t)) sqrt(1-abar_t/abar_prev)
      x <- sqrt(abar_prev) x0_pred + sqrt(1-abar_prev-sigma^2) eps
           + sigma N(0,1)

    with abar_prev = 1 at the final step, so eta=0 is deterministic given
    x_init.  A step whose sigma is 0 draws no noise.  `noise` (n_steps, B,
    H, W, C) supplies the injected noise, a parity hook like
    ddpm_sample's, and `rows` keeps some rows of the chain as there."""
    columns = ddim_tables(diffusion, num_steps, eta)
    n = len(columns["t"])
    draws = list(columns["sigma"] != 0.0)
    net = model.to_compute(compute_dtype)
    x = _start(net, cfg, generator, batch_size, x_init, rows)
    if model_fn is None:
        model_fn = make_model_fn(cfg, compute_dtype=compute_dtype, y=y,
                                 guidance_scale=guidance_scale)
    if noise is not None and noise.shape[0] < n:
        raise ValueError(f"noise has {noise.shape[0]} steps, chain needs {n}")
    at = _StepTables(x.device, **columns)
    z = torch.zeros_like(x)

    def step():
        eps = model_fn(net, x, at("t").expand(x.shape[0]))
        x0 = (x - at("c_eps") * eps) * at("c_x0")
        x_next = at("c_prev") * x0 + at("c_dir") * eps
        if any(draws):
            # + 0 * z at a step that draws nothing: x_next, exactly
            x_next = x_next + at("sigma") * z
        x.copy_(x_next)
        at.advance()

    _run_chain(step, z, n, draws, generator, noise, rows)
    return x


def make_ddim_sampler(cfg: UnetConfig, diffusion: GaussianDiffusion, *,
                      num_steps: int = 50, eta: float = 0.0,
                      batch_size: int = 1, compute_dtype=torch.float32,
                      y=None, guidance_scale: float = 1.0):
    """`sample(model, generator) -> (B, H, W, C)` closure over the DDIM
    chain's settings."""
    return lambda model, generator=None: ddim_sample(
        model, cfg, diffusion, generator, num_steps=num_steps, eta=eta,
        batch_size=batch_size, compute_dtype=compute_dtype,
        y=y, guidance_scale=guidance_scale)


def make_parallel_sampler(cfg: UnetConfig, diffusion: GaussianDiffusion,
                          mesh, *, batch_size: int,
                          compute_dtype=torch.float32, num_steps=None,
                          sampler: str = "ddpm", gather: bool = False):
    """`sample(model, generator) -> images` over the ranks of a
    `parallel.mesh.Mesh`: the serving side of the data-parallel step.
    `batch_size` is the global batch, which must divide by the data axis;
    each rank runs the whole chain (`sampler` "ddpm", or "ddim" of
    `num_steps`) on its rows of it, rank, rank + N, ...  The start and each
    step's noise are drawn for the global batch from `generator` (the same
    seed on every rank) and cut to the rank's rows, so the rows are those
    `make_sampler` / `make_ddim_sampler` give for the same generator.
    Returns the rank's rows, or with `gather` every row in the global
    order on every rank (an all-gather over the data axis: every rank
    calls it).  On a mesh with a model axis each model rank runs the whole
    model on the rows of its data index."""
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} does not divide over "
                         f"{mesh.data} ranks")
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler {sampler!r}")
    rows = mesh.rows

    def sample(model, generator=None):
        if sampler == "ddpm":
            x = ddpm_sample(model, cfg, diffusion, generator,
                            batch_size=batch_size, num_steps=num_steps,
                            compute_dtype=compute_dtype, rows=rows)
        else:
            x = ddim_sample(model, cfg, diffusion, generator,
                            num_steps=50 if num_steps is None else num_steps,
                            batch_size=batch_size,
                            compute_dtype=compute_dtype, rows=rows)
        if not gather:
            return x
        ranks = torch.empty((batch_size,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        distributed.all_gather(ranks, x, mesh.data_group)
        # rank r's row i is global row i * N + r
        return ranks.view((mesh.data,) + tuple(x.shape)).transpose(
            0, 1).reshape(ranks.shape)

    return sample


def to_uint8(images) -> np.ndarray:
    """[-1, 1] float images -> uint8 numpy array: (x + 1) * 127.5, clipped
    to [0, 255] and truncated."""
    arr = (images.detach().float().cpu().numpy() + 1.0) * 127.5
    return np.clip(arr, 0, 255).astype(np.uint8)
