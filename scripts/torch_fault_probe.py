"""Repeatability probe of the f32 path that
`tests/test_torch_gpu_kernels.py::test_autograd_reaches_q_k_v_w_and_pm_through_dense_and_flash[float32-32]`
reaches, on the card.

    python3 scripts/torch_fault_probe.py [--runs 30] [--launches 50]
                                         [--file-runs 2]

  1. launches each kernel of that path `--launches` times on the test's own
     inputs, each launch after the caching allocator's free blocks were
     filled with NaN (tensors of the outputs' and scratch's sizes allocated,
     filled and freed), and compares every output's bits with the first
     launch's: K1, K2 and K3 at the 1x1 geometry (f32 `masked_conv_*.cu`),
     K7 forward (f32 `flash_fwd.cu`) and the dQ and dK/dV pair (f32
     `flash_bwd.cu`), also against their plain versions;
  2. the test's autograd path `--runs` times in this process (the card's
     gradients bit for bit against the first run's, and against the CPU
     reference at the test's rtol/atol 1e-4), then the test function itself
     `--runs` times;
  3. the test alone in `--runs` fresh pytest processes (three at a time),
     and the whole GPU test file `--file-runs` times;
and prints one JSON summary (also `chiprun_out/fault_probe.json`). With
`--after-file N` it runs only N fresh processes that each run the whole GPU
test file in-process (the test itself deselected) and then hash each
side's gradients and the attention's intermediate tensors, the card's and
the CPU's apart (`chiprun_out/fault_after_file.json`): the side whose
bits change from process to process is the one that varies.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cpg_tpu_torch.ops import _build  # noqa: E402
from cpg_tpu_torch.ops import flash as fl  # noqa: E402
from cpg_tpu_torch.ops import masked_conv as mc  # noqa: E402
from cpg_tpu_torch.ops import masked_matmul as mm  # noqa: E402

TEST = ("tests/test_torch_gpu_kernels.py::"
        "test_autograd_reaches_q_k_v_w_and_pm_through_dense_and_flash"
        "[float32-32]")
N, T, H, HD = 2, 70, 2, 32


def inputs():
    """The test's numpy inputs, drawn in its order."""
    rng = np.random.RandomState(8)
    x0 = rng.randn(N * T, 48).astype(np.float32)
    ws = [(rng.randn(48, H * HD) * 0.2).astype(np.float32) for _ in range(3)]
    own = rng.choice([0, 1, 2], size=(48, H * HD)).astype(np.int8)
    pms = [(rng.randn(48, H * HD) * 0.01 + 0.005).astype(np.float32)
           for _ in range(3)]
    gout = rng.randn(N, T, H, HD).astype(np.float32)
    return x0, ws, own, pms, gout


def grads(dev):
    """The test's autograd path on `dev`: the gradients of x, w and pm."""
    x0, ws, own, pms, gout = inputs()
    leaves = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (x0, *ws, *pms)]
    town = torch.from_numpy(own).to(dev)
    q, k, v = (mm.masked_matmul(leaves[0], leaves[1 + i], town, leaves[4 + i],
                                2).reshape(N, T, H, HD) for i in range(3))
    out = fl.flash_mha(q, k, v, causal=True)
    (out * torch.from_numpy(gout).to(dev)).sum().backward()
    if dev != "cpu":
        torch.cuda.synchronize()
    return [a.grad.detach().cpu() for a in leaves]


def poison(dev, nbytes):
    """Fill free blocks of the caching allocator with NaN: tensors of each
    size in `nbytes` (four of each, and a few larger ones) allocated, filled
    and freed, so the next torch.empty of those sizes reads NaN."""
    held = []
    for b in list(nbytes) + [1 << 20, 1 << 22, 1 << 24]:
        for _ in range(4):
            held.append(torch.full((max(1, b // 4),), float("nan"),
                                   device=dev))
    torch.cuda.synchronize()
    del held


def kernel_launches(dev, launches):
    """Each kernel of the path `launches` times after poisoning: per output,
    launches whose bits differ from the first, and the first's max|diff|
    against the plain version."""
    x0, ws, own, pms, gout = inputs()
    x = torch.from_numpy(x0).to(dev)
    w, pm = (torch.from_numpy(a).to(dev) for a in (ws[0], pms[0]))
    town = torch.from_numpy(own).to(dev)
    x4, w4, own4, pm4 = mm._as_conv(x, w, town, pm)
    g4 = (torch.from_numpy(gout).reshape(N * T, 1, 1, H * HD)
          .to(dev).contiguous())
    qkv = [mm.masked_matmul(x, torch.from_numpy(ws[i]).to(dev), town,
                            torch.from_numpy(pms[i]).to(dev), 2)
           .reshape(N, T, H, HD).contiguous() for i in range(3)]
    q, k, v = qkv
    do = torch.from_numpy(gout).to(dev).contiguous()
    o, lse = fl.flash_fwd(q, k, v, True)
    _, d = fl.flash_bwd_dq(q, k, v, o, lse, do, True)
    cpu = lambda ts: [t.cpu() for t in ts]
    cases = {
        "k1_f32_1x1": (lambda: [mc.launch_fwd(x4, w4, own4, pm4, 2, 1,
                                              "VALID", 5e-3, "binary")],
                       lambda: [mc.masked_conv2d_plain(*cpu((x4, w4, own4,
                                                             pm4)), 2, 1,
                                                       "VALID")]),
        "k2_f32_1x1": (lambda: [mc.launch_bwd_dx(g4, x4, w4, own4, pm4, 2, 1,
                                                 "VALID", 5e-3, "binary")],
                       lambda: [mc.masked_conv2d_bwd_dx_plain(
                           *cpu((g4, x4, w4, own4, pm4)), 2, 1, "VALID")]),
        "k3_f32_1x1": (lambda: list(mc.launch_bwd_dw(g4, x4, w4, own4, 2, 1,
                                                     "VALID")),
                       lambda: list(mc.masked_conv2d_bwd_dw_plain(
                           *cpu((g4, x4, w4, own4)), 2, 1, "VALID"))),
        "k7_fwd_f32": (lambda: list(fl.flash_fwd(q, k, v, True)),
                       lambda: list(fl.flash_mha_plain(*cpu((q, k, v)),
                                                       True))),
        "k7_dq_f32": (lambda: list(fl.flash_bwd_dq(q, k, v, o, lse, do,
                                                   True)),
                      lambda: list(fl.flash_mha_bwd_dq_plain(
                          *cpu((q, k, v, o, lse, do)), True))),
        "k7_dkv_f32": (lambda: list(fl.flash_bwd_dkv(q, k, v, do, lse, d,
                                                     True)),
                       lambda: list(fl.flash_mha_bwd_dkv_plain(
                           *cpu((q, k, v, do, lse, d)), True))),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        first = kern()
        torch.cuda.synchronize()
        sizes = [t.numel() * t.element_size() for t in first]
        sizes.append(3 * 48 * 64 * 4)  # K3's split partials
        differ = [0] * len(first)
        nan_seen = [0] * len(first)
        for _ in range(launches):
            poison(dev, sizes)
            got = kern()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(first, got)):
                differ[i] += int(not torch.equal(a.view(torch.int32),
                                                 b.view(torch.int32)))
                nan_seen[i] += int(not bool(torch.isfinite(b).all()))
        want = plain()
        err = [float((a.cpu() - b).abs().max()) for a, b in zip(first, want)]
        out[name] = dict(launches_differing=differ, nonfinite=nan_seen,
                         first_vs_plain_max_abs=err)
        print(name, json.dumps(out[name]), flush=True)
    return out


def in_process(dev, runs):
    """The autograd path `runs` times: launches whose gradients differ from
    the first run's bits, and each run's worst relative miss against the
    CPU reference (|got - want| / (1e-4 + 1e-4 |want|), > 1 fails)."""
    ref = grads("cpu")
    first, differ, worst = None, 0, []
    for _ in range(runs):
        got = grads(dev)
        if first is None:
            first = got
        differ += int(not all(torch.equal(a, b) for a, b in zip(first, got)))
        worst.append(max(float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())
                         for g, w in zip(got, ref)))
    return dict(runs=runs, runs_differing=differ,
                worst_miss=max(worst), misses_over_1=sum(w > 1 for w in worst))


def test_in_process(dev, runs):
    """The test function itself `runs` times in this process."""
    import test_torch_gpu_kernels as tg

    fails = []
    for i in range(runs):
        try:
            tg.test_autograd_reaches_q_k_v_w_and_pm_through_dense_and_flash(
                dev, "float32", 32)
        except AssertionError as e:
            fails.append((i, str(e)[:600]))
    return dict(runs=runs, failed=len(fails), messages=fails[:3])


def pytest_runs(args_list, parallel):
    """Fresh pytest processes, `parallel` at a time: (rc, tail) each (the
    tail ends in pytest's summary of the failed tests)."""
    env = dict(os.environ)
    res, procs = [], []
    todo = list(args_list)
    while todo or procs:
        while todo and len(procs) < parallel:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pytest", "--noconftest", "-p",
                 "no:cacheprovider", "-q", "-rf", *todo.pop()], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        p = procs.pop(0)
        log, _ = p.communicate()
        res.append((p.returncode, log[-1500:] if p.returncode else
                    log.strip().splitlines()[-1]))
    return res


def sides(dev):
    """sha1 of the card's and the CPU's gradients (and of each side's dq,
    dk, dv of the attention), and the worst miss between the two sides, as
    `in_process` reads it."""
    import hashlib

    def h(ts):
        return hashlib.sha1(b"".join(t.detach().cpu().numpy().tobytes()
                                     for t in ts)).hexdigest()[:12]

    out = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        g = grads(d)
        out[name] = h(g)
        out[name + "_grads"] = g
    x0, ws, own, pms, gout = inputs()
    for name, d in (("cpu", "cpu"), ("card", dev)):
        qkv = [mm.masked_matmul(torch.from_numpy(x0).to(d),
                                torch.from_numpy(ws[i]).to(d),
                                torch.from_numpy(own).to(d),
                                torch.from_numpy(pms[i]).to(d), 2)
               .reshape(N, T, H, HD).contiguous() for i in range(3)]
        do = torch.from_numpy(gout).to(d)
        o, lse = fl.flash_fwd(*qkv, True)
        out[name + "_qkv"] = h(qkv)
        out[name + "_o_lse"] = h([o, lse])
        dq, dd = fl.flash_bwd_dq(*qkv, o, lse, do, True)
        out[name + "_dq_d"] = h([dq, dd])
        out[name + "_dk_dv"] = h(fl.flash_bwd_dkv(*qkv, do, lse, dd, True))
    out["worst_miss"] = max(
        float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())
        for g, w in zip(out.pop("card_grads"), out.pop("cpu_grads")))
    return out


def after_file(runs):
    """`runs` fresh processes, each running the whole GPU test file
    in-process first and then `sides`: which side's bits change from
    process to process."""
    code = ("import sys, json, pytest, torch; sys.path.insert(0, 'scripts');"
            "import torch_fault_probe as p;"
            "rc = pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-q',"
            " '-m', 'gpu', 'tests/test_torch_gpu_kernels.py', '-x',"
            " '--deselect', '" + TEST + "']);"
            "torch.backends.cudnn.allow_tf32 = False;"
            "torch.set_float32_matmul_precision('highest');"
            "print('SIDES ' + json.dumps(dict(p.sides(torch.device('cuda')),"
            " file_rc=int(rc))))")
    res = []
    for _ in range(runs):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith("SIDES ")]
        res.append(json.loads(line[-1][6:]) if line else
                   {"error": (r.stdout + r.stderr)[-800:]})
        print("after_file", json.dumps(res[-1]), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--file-runs", type=int, default=2)
    ap.add_argument("--after-file", type=int, default=0,
                    help="only: this many processes of `after_file`")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fault_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    print(f"build {_build.build_all():.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if a.after_file:
        res = after_file(a.after_file)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "fault_after_file.json"),
                  "w") as f:
            json.dump({"card": card, "runs": res}, f, indent=1)
        return 0
    summary = {"card": card, "kernels": kernel_launches(dev, a.launches)}
    summary["autograd_in_process"] = in_process(dev, a.runs)
    print("autograd", json.dumps(summary["autograd_in_process"]), flush=True)
    summary["test_in_process"] = test_in_process(dev, a.runs)
    print("test", json.dumps(summary["test_in_process"]), flush=True)
    one = pytest_runs([["-m", "gpu", TEST]] * a.runs, 3)
    summary["test_fresh_processes"] = dict(
        runs=len(one), failed=sum(rc != 0 for rc, _ in one),
        tails=[t for rc, t in one if rc][:3])
    print("fresh", json.dumps(summary["test_fresh_processes"]), flush=True)
    whole = pytest_runs([["-m", "gpu", "-p", "no:randomly",
                          "tests/test_torch_gpu_kernels.py"]] * a.file_runs, 1)
    summary["whole_file"] = dict(runs=len(whole),
                                 failed=sum(rc != 0 for rc, _ in whole),
                                 tails=[t for _, t in whole])
    print("file", json.dumps(summary["whole_file"]), flush=True)
    summary["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fault_probe.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
