"""Port operators vs the JAX reference: on identical uint8 input every
operator's item set equals the reference's, for several streams and
consumption formats (resolution, crop, sampling, activated subsets)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analytics import OPERATORS as REF_OPERATORS
from repro.analytics.accuracy import f1_score as ref_f1
from repro.analytics.scene import generate_segment
from repro.codec.transform import materialize
from repro.core.knobs import FidelityOption as RefFidelity
from repro.core.knobs import IngestSpec as RefSpec

from repro_torch.analytics.accuracy import f1_score
from repro_torch.analytics.operators import OPERATORS
from repro_torch.core.knobs import FidelityOption, IngestSpec

SPEC, REF_SPEC = IngestSpec(), RefSpec()
CFS = [("best", 1.0, 720, 1.0), ("good", 1.0, 360, 0.5),
       ("bad", 0.75, 540, 2 / 3), ("best", 0.5, 400, 1 / 5),
       ("worst", 1.0, 144, 1 / 30)]


@pytest.fixture(scope="module")
def inputs():
    """(stream, cf knobs) -> identical uint8 frames for both packages: the
    reference's own materialization of the CF (sampling, crop, resize,
    quality loss)."""
    out = {}
    for stream, seg in (("jackson", 0), ("dashcam", 1), ("park", 2),
                        ("empty", 0)):
        frames, _ = generate_segment(stream, seg, REF_SPEC)
        for knobs in CFS:
            cf = RefFidelity(*knobs)
            out[stream, knobs] = np.asarray(materialize(frames, cf, REF_SPEC))
    return out


@pytest.mark.parametrize("op_name", ["diff", "motion", "snn", "nn",
                                     "license", "ocr"])
def test_operator_items_equal_reference(inputs, op_name):
    ref_op, op = REF_OPERATORS[op_name], OPERATORS[op_name]
    n_items = 0
    for (stream, knobs), frames in inputs.items():
        ref_items = ref_op.detect(frames, RefFidelity(*knobs), REF_SPEC)
        items = op.detect(torch.from_numpy(frames), FidelityOption(*knobs),
                          SPEC)
        assert items == ref_items, (stream, knobs)
        n_items += len(items)
    assert n_items > 0 or op_name == "ocr"


@pytest.mark.parametrize("op_name", ["diff", "nn", "ocr"])
def test_operator_items_equal_reference_on_activated_subset(inputs, op_name):
    """Cascades pass activated frames with their timeline positions."""
    knobs = ("best", 1.0, 720, 1.0)
    frames = inputs["jackson", knobs]
    sel = np.array([0, 1, 2, 9, 10, 20, 21, 30])
    ref_items = REF_OPERATORS[op_name].detect(
        frames[sel], RefFidelity(*knobs), REF_SPEC, positions=sel)
    items = OPERATORS[op_name].detect(
        torch.from_numpy(frames[sel]), FidelityOption(*knobs), SPEC,
        positions=sel)
    assert items == ref_items


def test_ocr_reads_plates_like_the_reference():
    """OCR on every frame of plate-carrying scenes: the readings (and the
    patches K2 resizes for them) agree with the reference's."""
    n_read = 0
    for stream, seg in (("jackson", 1), ("tucson", 0), ("miami", 2)):
        frames, _ = generate_segment(stream, seg, REF_SPEC)
        cf = RefFidelity()
        ref_items = REF_OPERATORS["ocr"].detect(frames, cf, REF_SPEC)
        items = OPERATORS["ocr"].detect(torch.from_numpy(frames),
                                        FidelityOption(), SPEC)
        assert items == ref_items, stream
        n_read += len(items)
    assert n_read > 0


def test_f1_score_matches_reference():
    for a, b in (({1, 2}, {2, 3}), (set(), set()), ({1}, set()),
                 ({("x", 1)}, {("x", 1), ("y", 2)})):
        assert f1_score(a, b) == ref_f1(a, b)
