"""The port opens the committed golden containers (``tests/fixtures``, made
by the JAX package) and decodes them bit for bit as recorded: v1
(single-file, 3-tuple segments, untagged streams), v2 (sharded, 4-tuple) and
v3 (sharded, codec-tagged 5-tuple), with their byte accounting and codec
attribution, and the ``ip`` archive (v3 with ``pred_planes``), and the live v4 archive
(journaled, unsealed) replayed timestep by timestep.

Reads the fixtures and the recorded expectations only; imports nothing of
the JAX package.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.refactor import refactor_variables  # noqa: E402
from repro_torch.data.synthetic import ge_like_fields, smooth_field  # noqa: E402
from repro_torch.store import open_archive  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
V1_PATH = os.path.join(FIXTURES, "golden_v1.prs")
V2_DIR = os.path.join(FIXTURES, "golden_v2")
V3_DIR = os.path.join(FIXTURES, "golden_v3")
V4_DIR = os.path.join(FIXTURES, "golden_v4")
IP_DIR = os.path.join(FIXTURES, "golden_ip")
VARS = ("Vx", "Vy", "Vz")
CPU = "cpu"


def _load(name):
    with np.load(os.path.join(FIXTURES, name)) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def expected():
    return _load("golden_expected.npz")


@pytest.fixture(scope="module")
def expected_v34():
    return _load("golden_v34_expected.npz")


@pytest.fixture(scope="module")
def fresh_archive():
    fields = ge_like_fields(n=1 << 10, seed=0)
    return refactor_variables({k: fields[k] for k in VARS}, device=CPU)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("source,prefix", [(V1_PATH, ""), (V2_DIR, ""),
                                           (V3_DIR, "v3__")],
                         ids=["v1-single-file", "v2-sharded",
                              "v3-codec-tagged"])
def test_golden_archive_decodes_bit_identically(source, prefix, expected,
                                                expected_v34,
                                                fresh_archive):
    want = expected_v34 if prefix else expected
    fresh = fresh_archive.open()
    with open_archive(source, device=CPU) as sa:
        st = sa.open()
        for eps_i, eps in enumerate(expected["eps_ladder"]):
            for v in VARS:
                data, bound = st.reconstruct(v, float(eps))
                np.testing.assert_array_equal(
                    _bits(data), _bits(want[f"{prefix}{v}__eps{eps_i}"]),
                    err_msg=f"{source}: {v} at eps={eps}")
                assert bound == float(want[f"{prefix}{v}__bound{eps_i}"])
                # every dialect decodes to the same values as the legacy
                # fixtures and as a fresh refactor of the same fields
                np.testing.assert_array_equal(
                    _bits(data), _bits(expected[f"{v}__eps{eps_i}"]))
                ref, ref_bound = fresh.reconstruct(v, float(eps))
                np.testing.assert_array_equal(_bits(data), _bits(ref))
                assert bound == ref_bound
        assert st.bytes_retrieved == int(want[f"{prefix}bytes_retrieved"])


def test_golden_v3_codec_attribution():
    with open_archive(V3_DIR, device=CPU) as sa:
        by_codec = sa.codec_bytes()
        assert set(by_codec) - {"untagged"}
        assert sum(by_codec.values()) == \
            sum(e.size for e in sa.fetcher.index.values())


def test_golden_v1_reports_untagged_codecs():
    with open_archive(V1_PATH, device=CPU) as sa:
        assert set(sa.codec_bytes()) == {"untagged"}
        sa.open().reconstruct("Vx", 1e-5)
        stats = sa.fetcher.stats
        assert set(stats.codec_bytes) == {"untagged"}
        assert stats.codec_bytes["untagged"] == stats.bytes_fetched


def test_golden_full_retrieval_exhausts_archive():
    with open_archive(V2_DIR, device=CPU) as sa:
        st = sa.open()
        for v in VARS:
            data, bound = st.reconstruct(v, 1e-15)
            assert torch.isfinite(data).all()
            assert bound < 1e-10


@pytest.mark.parametrize("source,item", [(V4_DIR, "A9")],
                         ids=["v4-journaled"])
def test_unported_golden_archives_name_their_roadmap_item(source, item,
                                                          expected_v34):
    """The golden archives the port once refused now open: ``item`` names
    the ROADMAP item that ported each.  The live v4 archive (unsealed)
    replays its journal to the recorded per-timestep values, bounds and
    byte accounting."""
    with open_archive(source, device=CPU) as sa:
        assert sa.manifest["journal"] and not sa.sealed
        st = sa.open()
        reader = st.reader("T")
        for t in range(6):
            data, bound = reader.read(t)
            np.testing.assert_array_equal(
                _bits(data), _bits(expected_v34[f"v4__t{t}"]),
                err_msg=f"{item}: v4 timestep {t}")
            assert bound == float(expected_v34[f"v4__bound{t}"])
        assert st.bytes_retrieved == int(expected_v34["v4__bytes_retrieved"])
        assert sa.refresh() == 0


def test_golden_ip_decodes_bit_identically():
    """The committed method="ip" archive: reconstructions, certified
    bounds and byte accounting equal the recorded expectations bit for bit,
    and a fresh refactor of the same fields by the port reconstructs the
    same (the closed-loop prediction contract: ``pred_planes`` plus the
    fixed-order contribution sum)."""
    want = _load("golden_ip_expected.npz")
    fields = {"S": smooth_field((257,), seed=5, lo=-3.0, hi=9.0),
              "Vx": ge_like_fields(n=1 << 10, seed=0)["Vx"]}
    fresh = refactor_variables(fields, method="ip", device=CPU).open()
    with open_archive(IP_DIR, device=CPU) as sa:
        assert all(v.method == "ip" for v in sa.variables.values())
        st = sa.open()
        for i, eps in enumerate(want["ip__eps_ladder"]):
            for v in ("S", "Vx"):
                data, bound = st.reconstruct(v, float(eps))
                rec = want[f"ip__{v}__eps{i}"]
                assert np.array_equal(data.numpy().view(np.uint64),
                                      rec.view(np.uint64)), (v, eps)
                assert bound == float(want[f"ip__{v}__bound{i}"])
                ref, ref_bound = fresh.reconstruct(v, float(eps))
                assert torch.equal(ref.view(torch.int64),
                                   data.view(torch.int64)), (v, eps)
                assert ref_bound == bound
        assert st.bytes_retrieved == int(want["ip__bytes_retrieved"])
