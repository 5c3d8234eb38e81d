"""Golden-trajectory regression harness (port of ``msckf_mono_tpu/eval/golden.py``).

A deterministic f64 synthetic sequence run through the full filter at the
default ``MsckfConfig`` is stored as a golden ``.npz``; the regression
replays it and demands agreement to near machine precision. The port checks
itself against the same committed file the JAX package wrote,
``tests/golden/synthetic_f64.npz``, which belongs to the JAX package: the
port never writes it (``write_golden`` takes a path, ``--write`` needs
``--path``).

    python -m msckf_mono_tpu_torch.eval.golden                 # compare
    python -m msckf_mono_tpu_torch.eval.golden --write --path x.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

GOLDEN_SPEC = dict(n_frames=100, seed=12345, pixel_noise=0.5)
DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden", "synthetic_f64.npz",
)


def run_golden_sequence() -> dict:
    """The pinned configuration: f64, default MsckfConfig, fixed seed, on the
    CPU.

    The golden is defined as the f64 CPU run (the JAX package pins it the
    same way), so this runs on the CPU on any machine: the card's γ kernel
    takes f32 only (``ops/psd_cuda.gamma_psd``). The same spec in f32 on
    the card is a different run, compared with the golden at its own
    tolerance by the caller.
    """
    import torch

    from msckf_mono_tpu_torch.core import filter as msckf_filter
    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import init_filter_state
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.parallel.montecarlo import broadcast_frames
    from msckf_mono_tpu_torch.utils.config import MsckfConfig

    cfg = MsckfConfig()
    seq = synthetic.generate(cfg, **GOLDEN_SPEC)
    imu = ground_truth_init(
        p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
        v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4],
        b_g=seq.b_g, b_a=seq.b_a, dtype=torch.float64, device="cpu",
    )
    state = init_filter_state(cfg, imu, dtype=torch.float64, device="cpu")
    frames = broadcast_frames(synthetic.to_frame_inputs(seq, torch.float64, device="cpu"), 1)
    final, outs = msckf_filter.run_sequence(state, frames, cfg)
    return {
        "p": outs.p_I_G[:, 0].numpy().copy(),
        "q": outs.q_IG[:, 0].numpy().copy(),
        "v": outs.v_I_G[:, 0].numpy().copy(),
        "P_trace": np.asarray(np.trace(final.P[0].numpy())),
        "num_residualized": np.asarray(final.num_residualized[0].numpy()),
        "gt_p": seq.gt_p,
    }


def write_golden(path: str) -> str:
    res = run_golden_sequence()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **res)
    return path


def compare_to_golden(path: str = DEFAULT_PATH, rtol=1e-9, atol=1e-9) -> dict:
    """Re-run and diff. Returns max abs errors; raises AssertionError on drift."""
    golden = np.load(path)
    res = run_golden_sequence()
    errs = {}
    for key in ("p", "q", "v"):
        errs[key] = float(np.abs(res[key] - golden[key]).max())
        np.testing.assert_allclose(res[key], golden[key], rtol=rtol, atol=atol, err_msg=key)
    np.testing.assert_allclose(res["P_trace"], golden["P_trace"], rtol=1e-6)
    assert int(res["num_residualized"]) == int(golden["num_residualized"])
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true", help="write a golden file (needs --path)")
    ap.add_argument("--path", default=None, help=f"golden file (compare default: {DEFAULT_PATH})")
    args = ap.parse_args(argv)
    if args.write:
        if args.path is None:
            ap.error("--write needs --path: the committed golden belongs to the JAX package")
        print("wrote", write_golden(args.path))
    else:
        print("ok", compare_to_golden(args.path or DEFAULT_PATH))


if __name__ == "__main__":
    main()
