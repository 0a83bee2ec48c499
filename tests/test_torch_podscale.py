"""The port's pod-scale all-sky configuration (``parallel/scaling.py``)
on the CPU at the toy size of tests/test_scaling_profiling.py:57-65 (8
columns a chunk, 6 layers, 16 g-points in 2 bands, 4 temperatures, 6
pressures): the JAX package's dict and its chunking; each streamed
chunk's outputs bit for bit the fused all-sky step's
(``build_allsky_step``) on its entry of the host pool, entries that
differ, and the resident regime's last chunk the streamed one's on the
same entry."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky_step  # noqa: E402
from rte_rrtmgp_tpu_torch.parallel.scaling import (  # noqa: E402
    _podscale, _pool_entry, podscale_allsky)

TOY = dict(chunk_cols_per_device=8, ngpt_lw=16, nbnd_lw=2, ngpt_sw=16,
           nbnd_sw=2, ntemp=4, npres=6)
RUN = dict(TOY, reps_per_chunk=1, host_pool=3, verbose=False, device="cpu")


@pytest.mark.parametrize("stream", [True, False])
def test_podscale_chunking_small(stream):
    r = podscale_allsky(total_columns=4 * 8, nlay=6, stream=stream,
                        verbose=False, device="cpu", **TOY)
    assert set(r) == {"n_devices", "chunk_columns", "n_chunks",
                      "total_columns", "streamed_inputs", "seconds",
                      "cols_per_s", "cols_per_s_per_device"}
    assert r["n_devices"] == 1 and r["chunk_columns"] == 8
    assert r["n_chunks"] == 4 and r["total_columns"] == 32
    assert r["streamed_inputs"] is stream
    assert r["cols_per_s"] > 0
    assert r["cols_per_s_per_device"] == r["cols_per_s"]
    # a ragged total rounds up to whole chunks, each repeated
    r = podscale_allsky(total_columns=20, nlay=6, stream=stream,
                        reps_per_chunk=2, verbose=False, device="cpu", **TOY)
    assert r["n_chunks"] == 3 and r["total_columns"] == 48


def test_podscale_last_chunk_matches_fused_step():
    # 7 chunks over a pool of 3: chunk k reads entry k % 3, the last
    # entry 0, the resident chunk
    _, streamed = _podscale(7 * 8, 6, stream=True, keep=True, **RUN)
    _, resident = _podscale(3 * 8, 6, stream=False, **RUN)
    step, inputs = build_allsky_step(8, 6, 16, 2, 16, 2, 4, 6,
                                     device="cpu")
    refs = []
    for j in range(3):
        lw_up, _, sw_up, _, _ = step(_pool_entry(inputs, j))
        refs.append((lw_up[:, 0], sw_up[:, 0]))
    for j in range(1, 3):
        assert not any(torch.equal(a, b) for a, b in zip(refs[0], refs[j]))
    assert len(streamed) == 7
    for k, out in enumerate(streamed):
        for a, ref in zip(out, refs[k % 3]):
            assert tuple(a.shape) == (8,)
            assert torch.equal(a, ref)
            assert bool(torch.isfinite(a).all()) and bool((a > 0).any())
    assert len(resident) == 1
    for a, b in zip(streamed[-1], resident[0]):
        assert torch.equal(a, b)


def test_podscale_needs_a_device_unless_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        podscale_allsky(total_columns=8, nlay=6, verbose=False, **TOY)
