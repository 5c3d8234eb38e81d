"""On the card: the control comes out not correct, and the program comes out
correct, on the same seed, at a cut fleet over the cell's whole sequence.
The control is what the traffic file's ``check.control`` names: the
program's own TF32 image path on the shared camera; the plain reference in
float32 with TF32 on, in the program's place, on the tracks (the program has
no TF32 path there). Run on the chip:

    python -m pytest -p no:cacheprovider -m cuda portbench/tests/test_portbench_control.py
"""

import json
import sys

import pytest
import torch

from tiny import make_tiny, with_traffic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card_copy(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card computes")
    root = make_tiny(tmp_path_factory.mktemp("bench"), small=False)
    for traffic, batch in (("mc_jobs_tracks", 64), ("mc_jobs_images_shared", 32)):
        check = json.loads((root / f"portbench/traffic/{traffic}.json").read_text())["check"]
        with_traffic(root, traffic, batch=batch, check=dict(check, filters=8))
    sys.path.insert(0, str(root))
    return root


@pytest.mark.parametrize("workload", ["tracks-b1024", "images-shared-b256"])
def test_control_fails_and_program_passes(card_copy, workload):
    from portbench import control
    from portbench.harness import cell as cellmod
    from portbench.reference import compare

    cell = cellmod.find_cell(workload, card_copy)
    limits = cell.traffic["check"]["limits"]
    r = control.readings(cell, 2**31 + 7, 20.0, cellmod.Device("cuda"))
    assert compare.verdict(r["program"], limits)[1] is True, r
    assert compare.verdict(r["control"], limits)[1] is False, r
