"""The trainer's optimizer (``mvae_torch/train/optim.py``) and its kernel
(``mvae_torch/kernels/optim_kernels.py``, ``csrc/adam.cu``).

On the CPU:

* the plain version against ``torch.optim.Adam`` over three steps on the
  leaves of the flagship and of ``d2,p2,e2`` at full width, both groups,
  the curvature masked by hand for torch as the reference masks it: in
  burn-in, after it, and for a fixed curvature, with one gradient left
  None (a zero gradient, as optax sees it). The same ops on each side, the
  bias corrections in float64 on both: the first moment bit for bit, the
  second within 1e-6 (torch's CPU addcmul may fuse its multiply and add),
  the parameters within 1e-6 of the change and two ulps of their own
  (torch divides the moment by the denominator before it scales, the
  kernel's expressions scale first, and each rounds the sum);
* state dicts round trip both ways with ``torch.optim.Adam``: the state
  copies, each step count of the loaded torch optimizer is its own tensor,
  and the next step agrees;
* zeroing every state entry in place, as the benchmark's reset does,
  restarts the count: the next step is a fresh optimizer's first;
* the post-step hook runs after each step until its handle is removed;
* building a CPU ``Trainer`` and running an eager step leaves
  ``torch._dynamo`` unimported (``torch.optim.Optimizer`` imports it);
* ``csrc/adam.cu`` compiled for the host by ``g++`` against a stand-in for
  the CUDA headers, its blocks and threads run one after another: the
  kernel's update against the plain version's on leaves of ragged sizes,
  some unaligned to its vector width, float32 and bfloat16, over two
  launches (the counters advanced once a launch, the ticket back at 0);
* one launch takes ``MAX_LEAVES`` leaves, the source's ``ADAM_MAX_LEAVES``,
  and the wrapper and the source's launcher refuse one more.
  Float32 within 1e-6 relative (PyTorch's CPU lerp fuses its multiply and
  add only where it vectorizes; each other op rounds alike), one bfloat16
  ulp in bfloat16 (each side rounds once, from float32 results that may
  differ in their last place).

On a card (``cuda`` marker; skipped here): the kernel against its plain
version and against ``torch.optim.Adam(capturable=True)`` over three steps
in float32 and bfloat16 (tolerances in the test); a trainer's graphed and
eager steps bit for bit;
one ``adam`` launch a step replay; no ``multi_tensor_apply`` kernel in a
profiled step.
"""
import copy
import ctypes
import gc
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvae_torch.components import parse_components
from mvae_torch.data import ArrayDataset
from mvae_torch.kernels import optim_kernels
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer
from mvae_torch.train.trainer import _leaves, make_optimizer

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mvae_torch" / "kernels" / "csrc"
BETAS, EPS = (0.9, 0.999), 1e-8


def _params(spec, fixed, device="cpu", dtype=torch.float32, seed=0):
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=fixed),
                         (784,), h_dim=400)
    params = tvae.init_params(cfg, 1.0, dtype,
                              torch.Generator().manual_seed(seed),
                              torch.device(device))
    for t in _leaves(params):
        t.requires_grad_(True)
    return cfg, params


def _tc(burnin_epochs):
    return TrainConfig(lr=1e-3, curvature_lr=1e-4,
                       burnin_epochs=burnin_epochs)


def _ours(cfg, params, burnin_steps, device="cpu"):
    return make_optimizer(params, _tc(0), cfg.components,
                          torch.zeros((), dtype=torch.int64, device=device),
                          burnin_steps)


def _torch_adam(params, **kw):
    ours = make_optimizer(params, _tc(0), [], None, 0)
    return torch.optim.Adam([{"params": g["params"], "lr": g["lr"]}
                             for g in ours.param_groups],
                            betas=BETAS, eps=EPS, **kw)


def _grads(params, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(t.shape, generator=g).to(device, t.dtype)
            for t in _leaves(params)]


def _curvature(cfg, params):
    """(learnable, fixed) curvature leaves."""
    out = ([], [])
    for comp, cp in zip(cfg.components, params["components"]):
        if "c_param" in cp:
            out[bool(comp.fixed_curvature)].append(cp["c_param"])
    return out


def _masked_by_hand(cfg, params, grads, unfrozen: bool):
    """The reference's mask on a list of gradients (leaf order)."""
    learnable, fixed = (set(map(id, ts)) for ts in _curvature(cfg, params))
    out = []
    for t, g in zip(_leaves(params), grads):
        if id(t) in fixed or (id(t) in learnable and not unfrozen):
            g = torch.zeros_like(g)
        out.append(g)
    return out


def _order(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def _change_close(a, b, p0, rtol):
    """Parameters ``a`` and ``b`` after one step from ``p0``: their changes
    within ``rtol`` of each other, and two float32 ulps of the parameter
    (each side's sum may land an ulp or so from the exact one: torch's CPU
    path rounds its quotient, its scaled quotient and the sum, the kernel's
    expressions scale first)."""
    allowed = (rtol * (b - p0).abs()
               + 2 * torch.finfo(torch.float32).eps * b.abs())
    assert bool(((a - b).abs() <= allowed).all()), float(
        ((a - b).abs() - allowed).max())


# --- the plain version against torch.optim.Adam --------------------------

@pytest.mark.parametrize("case", ["burnin", "after", "fixed"])
@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2"])
def test_plain_adam_matches_torch_adam(spec, case):
    fixed = case == "fixed"
    burnin = 10 if case == "burnin" else 0
    cfg, mine = _params(spec, fixed)
    _, theirs = _params(spec, fixed)
    ours, ref = _ours(cfg, mine, burnin), _torch_adam(theirs)
    assert [g["lr"] for g in ours.param_groups] == [1e-3, 1e-4]
    learnable, fixed_leaves = _curvature(cfg, mine)
    assert len(learnable if not fixed else fixed_leaves) == 2
    none_leaf = 4              # a head's weight: its gradient left None
    for step in range(3):
        # each step from the same parameters, so that its change is held
        with torch.no_grad():
            for a, b in zip(_leaves(theirs), _leaves(mine)):
                a.copy_(b)
        p0 = [t.detach().clone() for t in _leaves(mine)]
        grads = _grads(mine, step)
        for i, (t, g) in enumerate(zip(_leaves(mine), grads)):
            t.grad = None if i == none_leaf else g.clone()
        grads[none_leaf] = torch.zeros_like(grads[none_leaf])
        for t, g in zip(_leaves(theirs), _masked_by_hand(
                cfg, theirs, grads, unfrozen=step >= burnin)):
            t.grad = g.clone()
        ours.step()
        ref.step()
        for a, b, p in zip(_leaves(mine), _leaves(theirs), p0):
            sa, sb = ours.state[a], ref.state[b]
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
            torch.testing.assert_close(sa["exp_avg_sq"], sb["exp_avg_sq"],
                                       rtol=1e-6, atol=0)
            assert float(sa["step"]) == float(sb["step"]) == step + 1
            _change_close(a, b, p, 1e-6)
    assert int(ours.step_t) == 3
    for t in learnable + fixed_leaves:
        moved = not torch.equal(t, p0[[id(x) for x in _leaves(mine)]
                                     .index(id(t))])
        assert moved == (case == "after")


# --- state dicts ------------------------------------------------------------

def _steps(opt, params, seeds):
    for s in seeds:
        for t, g in zip(_leaves(params), _grads(params, s)):
            t.grad = g
        opt.step()


def test_state_dict_loads_into_torch_adam_and_back():
    cfg, mine = _params("h2,s2,e2", False)
    _, theirs = _params("h2,s2,e2", False)
    ours, ref = _ours(cfg, mine, 0), _torch_adam(theirs)
    _steps(ours, mine, [0, 1])
    with torch.no_grad():
        for a, b in zip(_leaves(theirs), _leaves(mine)):
            a.copy_(b)
    ref.load_state_dict(copy.deepcopy(ours.state_dict()))
    steps = [ref.state[p]["step"] for p in _order(ref)]
    assert len({id(s) for s in steps}) == len(steps)
    for a, b in zip(_order(ours), _order(ref)):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ours.state[a][name], ref.state[b][name])
    p0 = [t.detach().clone() for t in _leaves(mine)]
    _steps(ours, mine, [2])
    _steps(ref, theirs, [2])
    assert all(float(ref.state[p]["step"]) == 3 for p in _order(ref))
    for a, b, p in zip(_leaves(mine), _leaves(theirs), p0):
        _change_close(a, b, p, 1e-6)

    # and back: torch's state into a fresh optimizer of ours
    _, back = _params("h2,s2,e2", False)
    again = _ours(cfg, back, 0)
    again.load_state_dict(ref.state_dict())
    assert float(again.state_dict()["state"][0]["step"]) == 3
    for a, b in zip(_order(again), _order(ref)):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(again.state[a][name], ref.state[b][name])


def test_load_keeps_the_tensors_and_refuses_other_layouts():
    cfg, params = _params("h2,s2,e2", False)
    opt = _ours(cfg, params, 0)
    _steps(opt, params, [0])
    held = [id(t) for st in opt.state.values() for t in st.values()]
    sd = copy.deepcopy(opt.state_dict())
    _steps(opt, params, [1])
    opt.load_state_dict(sd)
    assert [id(t) for st in opt.state.values() for t in st.values()] == held
    assert float(opt.state_dict()["state"][3]["step"]) == 1
    sd["state"][3]["step"] = torch.tensor(5.0)
    with pytest.raises(ValueError, match="one step count"):
        opt.load_state_dict(sd)
    sd["param_groups"] = sd["param_groups"][:1]
    with pytest.raises(ValueError, match="groups"):
        opt.load_state_dict(sd)


def test_zeroed_state_restarts_the_count():
    """``benchmark/programs.reset``: every state entry zeroed in place; the
    next step is a fresh optimizer's first from the same parameters."""
    cfg, params = _params("d2,p2,e2", False)
    opt = _ours(cfg, params, 0)
    _steps(opt, params, [0, 1])
    with torch.no_grad():
        for st in opt.state.values():
            for t in st.values():
                assert torch.is_tensor(t)
                t.zero_()
        opt.step_t.zero_()
    _, fresh_params = _params("d2,p2,e2", False)
    with torch.no_grad():
        for a, b in zip(_leaves(fresh_params), _leaves(params)):
            a.copy_(b)
    fresh = _ours(cfg, fresh_params, 0)
    _steps(opt, params, [7])
    _steps(fresh, fresh_params, [7])
    for a, b in zip(_leaves(params), _leaves(fresh_params)):
        assert torch.equal(a, b)
    assert int(opt.step_t) == int(fresh.step_t) == 1


def test_step_post_hook_runs_until_removed():
    cfg, params = _params("h2,s2,e2", False)
    opt = _ours(cfg, params, 0)
    seen = []
    handle = opt.register_step_post_hook(
        lambda o, args, kwargs: seen.append((o, args, kwargs)))
    _steps(opt, params, [0, 1])
    assert seen == [(opt, (), {})] * 2
    handle.remove()
    _steps(opt, params, [2])
    assert len(seen) == 2


def test_groups_carry_torch_adam_keys():
    cfg, params = _params("h2,s2,e2", False)
    opt = _ours(cfg, params, 0)
    ref = _torch_adam(_params("h2,s2,e2", False)[1])
    assert set(opt.defaults) == set(ref.defaults)
    assert opt.defaults["capturable"] is False
    for g in opt.param_groups:
        assert set(g) == set(ref.param_groups[0])
    _steps(opt, params, [0])
    opt.zero_grad()
    assert all(t.grad is None for t in _leaves(params))


_NO_DYNAMO = """
import sys
import numpy as np
from mvae_torch import TrainConfig, Trainer, VAEConfig, parse_components
from mvae_torch.data import ArrayDataset
x = (np.random.default_rng(0).uniform(size=(16, 24)) > 0.5).astype(
    np.float32)
cfg = VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False), (24,),
                h_dim=8)
tr = Trainer(cfg, ArrayDataset("toy", x, x[:8].copy(), (24,), True),
             TrainConfig(batch_size=8, burnin_epochs=0), run_dir=sys.argv[1],
             device="cpu")
tr._train_step(tr._train_data[:8])
assert int(tr._step_t) == 1 and tr.opt.state
print("torch._dynamo" in sys.modules)
"""


def test_cpu_trainer_step_imports_no_dynamo(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_DYNAMO, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


# --- csrc/adam.cu compiled for the host ------------------------------------

_STUB = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
#define __shared__ static
struct HostIdx { unsigned x, y; };
static HostIdx blockIdx, threadIdx, gridDim;
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
static inline float4 make_float4(float x, float y, float z, float w) {
  float4 r = {x, y, z, w};
  return r;
}
static inline void __syncthreads() {}
static inline void __threadfence() {}
static inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p += v;
  return old;
}
"""

# bfloat16 as the card stores it: the high half of a float32, rounded to
# nearest even
_BF16_STUB = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
static inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned u = (unsigned)h.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  h.x = (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  return h;
}
static inline float __low2float(__nv_bfloat162 a) {
  return __bfloat162float(a.x);
}
static inline float __high2float(__nv_bfloat162 a) {
  return __bfloat162float(a.y);
}
static inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  __nv_bfloat162 r = {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
  return r;
}
"""

# adam_launch's table and grid, every block and thread run in turn
_HARNESS = r"""
template <class T>
static int run(const AdamLeafIn* leaves, int count, float* step_count,
               long long* step_t, unsigned* ticket, long long burnin,
               double b1, double b2, double eps) {
  AdamTable table = {};
  const long long blocks = adam_table(leaves, count, &table);
  if (blocks == 0) return 1;
  const AdamBetas h = adam_betas(b1, b2, eps);
  gridDim.x = (unsigned)blocks;
  for (long long b = 0; b < blocks; ++b) {
    blockIdx.x = (unsigned)b;
    for (int t = 0; t < ADAM_THREADS; ++t) {
      threadIdx.x = t;
      adam_kernel<T>(table, step_count, step_t, ticket, burnin, h);
    }
  }
  return 0;
}

extern "C" int host_run(const AdamLeafIn* leaves, int count, int bf16,
                        float* step_count, long long* step_t,
                        unsigned* ticket, long long burnin, double b1,
                        double b2, double eps) {
  return bf16 ? run<__nv_bfloat16>(leaves, count, step_count, step_t, ticket,
                                   burnin, b1, b2, eps)
              : run<float>(leaves, count, step_count, step_t, ticket, burnin,
                           b1, b2, eps);
}
"""


@pytest.fixture(scope="module")
def adam_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    work = tmp_path_factory.mktemp("adam_host")
    (work / "cuda_runtime.h").write_text(_STUB)
    (work / "cuda_bf16.h").write_text(_BF16_STUB)
    body = (CSRC / "adam.cu").read_text().split('extern "C"')[0]
    src = work / "adam.cpp"
    src.write_text(body + _HARNESS)
    out = work / "adam.so"
    proc = subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared",
                           "-fPIC", "-I", str(work), "-o", str(out),
                           str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, f"g++ failed for adam.cu:\n{proc.stderr}"
    fn = ctypes.CDLL(str(out)).host_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_double] * 3)
    return fn


# (elements, offset in its buffer): ragged sizes, one of more than a block's
# tile, leaves at offsets that break the vector width
_HOST_LEAVES = [(1, 0), (5, 0), (4100, 0), (2048, 0), (37, 1), (6000, 3),
                (8, 2)]


def _host_case(dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def buf(n, off, scale=1.0):
        base = (torch.randn(n + off, generator=g) * scale).to(dtype)
        return base[off:]
    kinds = [optim_kernels.PLAIN, optim_kernels.CURVATURE, optim_kernels.PLAIN,
             optim_kernels.FIXED, optim_kernels.CURVATURE, optim_kernels.PLAIN,
             optim_kernels.PLAIN]
    leaves = []
    for i, (n, off) in enumerate(_HOST_LEAVES):
        p = buf(n, off, 0.05)
        grad = None if i == 2 else buf(n, off)
        # the curvature leaves' moments start at zero, so a masked one
        # stays where it is
        scale = 0.0 if kinds[i] != optim_kernels.PLAIN else 0.01
        m = buf(n, off, scale)
        v = buf(n, off, scale).abs()
        leaves.append((p, grad, m, v))
    lrs = [1e-3, 1e-4, 1e-3, 1e-4, 1e-4, 1e-3, 1e-3]
    return leaves, kinds, lrs


@pytest.mark.parametrize("burnin", [0, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_source_matches_plain_version(adam_host, dtype, burnin):
    leaves, kinds, lrs = _host_case(dtype, 11)
    ref = [[None if t is None else t.clone() for t in leaf]
           for leaf in leaves]
    count, step_t = torch.tensor(3.0), torch.tensor(4, dtype=torch.int64)
    ref_count, ref_step = count.clone(), step_t.clone()
    ticket = torch.zeros((), dtype=torch.int32)
    for launch in range(2):
        for leaf, r in zip(leaves, ref):     # each launch from the same p
            r[0].copy_(leaf[0])
        table = (optim_kernels._Leaf * len(leaves))(*[
            optim_kernels._Leaf(p.data_ptr(),
                                None if g is None else g.data_ptr(),
                                m.data_ptr(), v.data_ptr(), p.numel(), lr,
                                kind)
            for (p, g, m, v), kind, lr in zip(leaves, kinds, lrs)])
        assert adam_host(ctypes.addressof(table), len(leaves),
                         int(dtype == torch.bfloat16), count.data_ptr(),
                         step_t.data_ptr(), ticket.data_ptr(), burnin,
                         *BETAS, EPS) == 0
        p0 = [leaf[0].clone() for leaf in ref]
        optim_kernels.adam_ref(*[[leaf[j] for leaf in ref] for j in range(4)],
                               kinds, lrs, ref_count, ref_step, burnin, BETAS,
                               EPS)
        assert float(count) == float(ref_count) == 4 + launch
        assert int(step_t) == int(ref_step) == 5 + launch
        assert int(ticket) == 0
        for (p, _, m, v), (rp, _, rm, rv), q in zip(leaves, ref, p0):
            if dtype == torch.float32:
                for a, b in ((m, rm), (v, rv)):
                    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)
                _change_close(p, rp, q, 1e-6)
            else:
                for a, b in ((p, rp), (m, rm), (v, rv)):
                    assert _bf16_ulps(a, b) <= 1
    # the curvature leaves move only once the mask opens; the fixed one never
    for i in (1, 4):
        moved = not torch.equal(leaves[i][0], _host_case(dtype, 11)[0][i][0])
        assert moved == (burnin == 0)
    assert torch.equal(leaves[3][0], _host_case(dtype, 11)[0][3][0])


@pytest.mark.parametrize("extra", [0, 1])
def test_one_launch_takes_at_most_max_leaves(adam_host, extra):
    """``MAX_LEAVES`` is ``csrc/adam.cu``'s ``ADAM_MAX_LEAVES``; a table of
    that many leaves steps, one more is refused by the source's launcher and
    by the wrapper, which then changes nothing."""
    src = (CSRC / "adam.cu").read_text()
    assert f"#define ADAM_MAX_LEAVES {optim_kernels.MAX_LEAVES}\n" in src
    n = optim_kernels.MAX_LEAVES + extra
    g = torch.Generator().manual_seed(4)
    params = [torch.randn(3 + i % 5, generator=g) for i in range(n)]
    grads = [torch.randn(t.shape, generator=g) for t in params]
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    kinds, lrs = [optim_kernels.PLAIN] * n, [1e-3] * n
    before = [t.clone() for t in params]
    # the source's launcher, on copies
    hp, hm, hv = ([t.clone() for t in ts] for ts in (params, m, v))
    table = (optim_kernels._Leaf * n)(*[
        optim_kernels._Leaf(p.data_ptr(), gr.data_ptr(), mm.data_ptr(),
                            vv.data_ptr(), p.numel(), 1e-3, kind)
        for p, gr, mm, vv, kind in zip(hp, grads, hm, hv, kinds)])
    counters = [torch.zeros(()), torch.zeros((), dtype=torch.int64),
                torch.zeros((), dtype=torch.int32)]
    assert adam_host(ctypes.addressof(table), n, 0,
                     *[t.data_ptr() for t in counters], 0, *BETAS,
                     EPS) == extra
    assert float(counters[0]) == 1 - extra
    assert all(torch.equal(a, b) != (extra == 0)
               for a, b in zip(hp, before))
    # the wrapper
    count, step_t, ticket = (t.zero_() for t in counters)
    if extra:
        with pytest.raises(ValueError, match="at most"):
            optim_kernels.adam(params, grads, m, v, kinds, lrs, count,
                               step_t, ticket, 0, BETAS, EPS)
    else:
        optim_kernels.adam(params, grads, m, v, kinds, lrs, count, step_t,
                           ticket, 0, BETAS, EPS)
    assert float(count) == int(step_t) == 1 - extra
    assert all(torch.equal(a, b) != (extra == 0)
               for a, b in zip(params, before))


# --- on a card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/adam.cu runs only there")
    return torch.device("cuda", 0)


def _bf16_ulps(a, b, *before):
    """|a - b| in bfloat16 ulps of the largest magnitude in their update:
    of a, b and the values ``before`` the step (where the update nearly
    cancels, the result is exact and the rounding is the operands')."""
    a, b = a.detach().float(), b.detach().float()
    scale = torch.maximum(a.abs(), b.abs())
    for t in before:
        scale = torch.maximum(scale, t.detach().float().abs())
    ulp = 2.0 ** (torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    return float(((a - b).abs() / ulp).max())


def _bf16_change_close(a, b, p0, share):
    """bfloat16 parameters ``a`` and ``b`` after one step from ``p0``:
    within one ulp of the update's largest magnitude (each side rounds its
    sum once) and ``share`` of the step."""
    a, b, p0 = (t.detach().float() for t in (a, b, p0))
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()), p0.abs())
    ulp = 2.0 ** (torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    return bool(((a - b).abs() <= ulp + share * (b - p0).abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_and_torch_adam_on_card(dtype):
    """Three steps of the flagship's leaves after burn-in. Against the plain
    version on the card, the same expressions: float32 within 1e-6 (an ulp
    or two where the two round alike but for fused operations), bfloat16
    within one ulp. Against torch's capturable foreach Adam: the moments
    the same; the parameters' change within 1e-4 in float32 (its bias
    corrections are taken in float32: 1 - 0.999 is 1.3e-5 off, its powf up
    to two ulps of 0.999^t, up to 6e-5 of 1 - 0.999^2, halved by the square
    root); in bfloat16 the moments within two ulps (torch rounds v twice,
    the kernel once) and the parameters within an ulp and 1.5% of the step
    (torch rounds its denominator to bfloat16 three times and v twice,
    each by up to 0.2%; on the CPU its bfloat16 path reads 0.8% past the
    ulp). An ulp is taken of the largest magnitude in the update: where it
    nearly cancels, the result is exact and the rounding the operands'.
    Each step starts the three from the kernel's parameters and moments, so
    that one step's arithmetic is held."""
    dev = _card()
    sets = [_params("h2,s2,e2", False, dev, dtype) for _ in range(3)]
    (cfg, ours_p), (_, plain_p), (_, torch_p) = sets
    ours = _ours(cfg, ours_p, 0, dev)
    ref = _torch_adam(torch_p, capturable=True, foreach=True)
    st = {"count": torch.zeros((), device=dev),
          "step_t": torch.zeros((), dtype=torch.int64, device=dev),
          "m": [torch.zeros_like(t) for t in _leaves(plain_p)],
          "v": [torch.zeros_like(t) for t in _leaves(plain_p)]}
    kinds = [dict(zip(map(id, _order(ours)), ours.kinds))[id(t)]
             for t in _leaves(ours_p)]
    lrs = [1e-4 if k else 1e-3 for k in kinds]
    launches = optim_kernels.adam.launches
    for step in range(3):
        grads = _grads(ours_p, step, dev)
        # each step from the same parameters and moments
        with torch.no_grad():
            for i, t in enumerate(_leaves(ours_p)):
                _leaves(plain_p)[i].copy_(t)
                _leaves(torch_p)[i].copy_(t)
                if step:
                    theirs = ref.state[_leaves(torch_p)[i]]
                    for mv, name in ((st["m"], "exp_avg"),
                                     (st["v"], "exp_avg_sq")):
                        mv[i].copy_(ours.state[t][name])
                        theirs[name].copy_(ours.state[t][name])
        p0 = [t.detach().clone() for t in _leaves(ours_p)]
        m0 = [m.clone() for m in st["m"]]
        v0 = [v.clone() for v in st["v"]]
        for params in (ours_p, torch_p):
            for t, g in zip(_leaves(params), grads):
                t.grad = g.clone()
        ours.step()
        ref.step()
        optim_kernels.adam_ref([t.detach() for t in _leaves(plain_p)],
                               grads, st["m"], st["v"], kinds, lrs,
                               st["count"], st["step_t"], 0, BETAS, EPS)
        torch.cuda.synchronize()
        for i, t in enumerate(_leaves(ours_p)):
            mine = ours.state[t]
            theirs = ref.state[_leaves(torch_p)[i]]
            for name, (p, m, v), tol, rtol, share in (
                    ("plain", (_leaves(plain_p)[i], st["m"][i], st["v"][i]),
                     1.0, 1e-6, 0.0),
                    ("torch", (_leaves(torch_p)[i], theirs["exp_avg"],
                               theirs["exp_avg_sq"]), 2.0, 1e-4, 0.015)):
                if dtype == torch.float32:
                    torch.testing.assert_close(mine["exp_avg"], m, rtol=1e-6,
                                               atol=1e-12)
                    torch.testing.assert_close(mine["exp_avg_sq"], v,
                                               rtol=1e-6, atol=1e-12)
                    _change_close(t, p, p0[i], rtol)
                else:
                    assert _bf16_change_close(t, p, p0[i], share), (name, i)
                    for a, b, before in (
                            (mine["exp_avg"], m, (m0[i], 0.1 * grads[i])),
                            (mine["exp_avg_sq"], v, (v0[i],))):
                        assert _bf16_ulps(a, b, *before) <= tol, (name, i)
    assert optim_kernels.adam.launches == launches + 3
    assert int(ours.step_t) == 3
    assert float(ours.state_dict()["state"][0]["step"]) == 3


def _card_trainer(tmp_path, name, steps=3):
    # the earlier tests' trainers hold captured graphs in reference cycles:
    # collected now, not inside this trainer's capture (a graph destroyed
    # while another captures invalidates that capture)
    gc.collect()
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(64 * steps, 784)).astype(np.float32)
    cfg = tvae.VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False),
                         (784,), h_dim=400)
    ds = ArrayDataset("tiny", x, x[:128].copy(), (784,), True)
    tc = TrainConfig(epochs=1, batch_size=64, burnin_epochs=1, seed=3,
                     eval_batch_size=64, likelihood_n=500)
    return Trainer(cfg, ds, tc, str(tmp_path / name))


@pytest.mark.cuda
def test_graphed_and_eager_steps_equal_on_card(tmp_path):
    _card()
    graphed, eager = (_card_trainer(tmp_path, n) for n in ("g", "e"))
    for epoch in range(3):   # three eager steps; the capture; replays
        graphed.train_one_epoch(epoch)
        eager._train_one_epoch_eager(epoch)
    assert graphed.graph_path["path"] == "graph"
    assert int(graphed._step_t) == int(eager._step_t) == 9
    for a, b in zip(_leaves(graphed.params), _leaves(eager.params)):
        assert torch.equal(a, b)
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graphed.opt.state[a][name],
                               eager.opt.state[b][name])


@pytest.mark.cuda
def test_one_adam_launch_a_step_and_no_foreach_kernel_on_card(tmp_path):
    _card()
    tr = _card_trainer(tmp_path, "t")
    assert tr.fused_paths["optimizer"]["active"]
    tr.train_one_epoch(0)
    tr.train_one_epoch(1)
    launches = optim_kernels.adam.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train_one_epoch(2)
    torch.cuda.synchronize()
    assert optim_kernels.adam.launches == launches + 3
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "multi_tensor_apply" in n]
    assert sum("adam_kernel" in n for n in names) == 3
