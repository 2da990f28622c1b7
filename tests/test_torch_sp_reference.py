"""The JAX package's own float32 reference FER of exact sum-product on the
judged code, the interval the port's sum-product run is held to on the
card (chip_smoke.py).

artifacts/judged_sumproduct50.csv was written by the Pallas kernel on a
TPU: its row at 2.0 dB is FER 4.562e-3, Wilson interval [4.075e-3,
5.108e-3].  The jnp reference decoder of the same package, which follows
the golden float32 contract the port follows, decodes better than that
on the CPU: run here through the package's own run_ber (flooding, 50
iterations, 2.0 dB, 65,536 frames), its interval lies below the TPU
row's.  So the TPU row cannot be the port's yardstick; this run is.

    JAX_PLATFORMS=cpu python tests/test_torch_sp_reference.py

prints the run (about a minute on one CPU core).
"""

import numpy as np

from tpu_ldpc.codes import LdpcCode
from tpu_ldpc.report.waterfall import wilson_interval
from tpu_ldpc.sim.mc import DecodeCfg, run_ber

TPU_ROW_2DB = (4.074653e-03, 5.108183e-03)  # artifacts/judged_sumproduct50.csv


def jnp_reference_point(seed=0, frames=65536):
    """(frame errors, frames, Wilson 95% interval, mean iterations)."""
    res = run_ber(LdpcCode.judged(), [2.0], DecodeCfg(algo="sumproduct"),
                  batch=2048, target_frame_errors=10**9, max_frames=frames,
                  seed=seed)[0]
    return (res.frame_errors, res.frames,
            wilson_interval(res.frame_errors, res.frames), res.mean_iters)


def test_jnp_sumproduct_fer_at_2db_is_below_the_tpu_row():
    errors, frames, (lo, hi), mean_iters = jnp_reference_point()
    assert frames == 65536
    assert 150 < errors < 300
    assert hi < TPU_ROW_2DB[0]  # the intervals do not overlap
    assert 8.5 < mean_iters < 10.5
    # the interval chip_smoke.py holds the port's sum-product run to
    np.testing.assert_allclose((lo, hi), (2.999297e-03, 3.894854e-03),
                               rtol=1e-5)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for seed in (0, 1):
        errors, frames, ci, mean_iters = jnp_reference_point(seed)
        print(f"seed {seed}: {errors}/{frames} frame errors, FER "
              f"{errors / frames:.6e}, Wilson 95% [{ci[0]:.6e}, {ci[1]:.6e}]"
              f", mean iterations {mean_iters:.4f}; TPU row {TPU_ROW_2DB}")
