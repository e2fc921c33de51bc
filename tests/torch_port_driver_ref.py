"""The JAX package's run driver as the reference of tests/test_torch_driver.py.

    python tests/torch_port_driver_ref.py DIR

Runs in a fresh interpreter (ROADMAP R1: the coupled step's JAX programs
compile outside the xdist workers), with the test suite's JAX settings
(tests/conftest.py: CPU, float64, the persistent compile cache). DIR holds
init.pkl: the port's initial coupled state and cam_in as numpy
(convert.atmstate_to_numpy, convert.camin_to_numpy) and the model's size.
The script builds the JAX model of tests/test_driver_chunked.py's setup
(FVConfig(nsplit=2, nspltrac=1), the XLA small step: unfused, as the
port's "matmul" step; its polar filter is the FFT, since JAX's driver
traces the grid and the matmul filter needs a concrete one), runs
`driver.run(model, state, cam_in, 4, hist_every=2, ckpt_every=2)` into
DIR/jax and writes there, besides the tapes and checkpoints, final/ (the
final state by utils.checkpoint.save_checkpoint) and leaf_names.json (the
path of each leaf of the JAX AtmState in jax.tree.flatten order). The JAX
writers take their scipy and np.savez routes, which write the same data:
the script never runs `make` in native/, nor loads a library there that
another test process may be building.
"""

import json
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (CPU, float64, compile cache)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cam_nor_physics_tpu.driver import run  # noqa: E402
from cam_nor_physics_tpu.utils import ckptio_native, histio_native  # noqa: E402
from cam_nor_physics_tpu.models.atm_comp import AtmModel, AtmState  # noqa: E402
from cam_nor_physics_tpu.models.coupling.camsrfexch import CamIn  # noqa: E402
from cam_nor_physics_tpu.models.fv.cd_core import DynState  # noqa: E402
from cam_nor_physics_tpu.models.physics.physics_buffer import \
    PhysicsBuffer  # noqa: E402
from cam_nor_physics_tpu.models.physics.state import PhysicsState  # noqa: E402
from cam_nor_physics_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from cam_nor_physics_tpu.utils.config import FVConfig  # noqa: E402

NSTEPS = 4


def jax_state(fields):
    pb, lifetimes = fields["pbuf"]
    return AtmState(
        dyn=DynState(**{k: jnp.asarray(v) for k, v in fields["dyn"].items()}),
        phys=PhysicsState(**{k: jnp.asarray(v)
                             for k, v in fields["phys"].items()}),
        pbuf=PhysicsBuffer(fields={k: jnp.asarray(v) for k, v in pb.items()},
                           lifetimes=lifetimes),
        phis=jnp.asarray(fields["phis"]),
        nstep=jnp.asarray(fields["nstep"], jnp.int32))


def main(root):
    for mod in (histio_native, ckptio_native):
        mod.build_native = lambda force=False: False
    jax.config.update("jax_disable_most_optimizations", True)
    with open(os.path.join(root, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    im, jm, km = init["shape"]
    model = AtmModel.create(im, jm, km, dt=1800.0,
                            fv_cfg=FVConfig(nsplit=2, nspltrac=1,
                                            use_pallas=False),
                            filter_impl="fft")
    state = jax_state(init["state"])
    cam_in = CamIn(**{k: jnp.asarray(v) for k, v in init["cam_in"].items()})
    out = os.path.join(root, "jax")
    final, _ = run(model, state, cam_in, NSTEPS, out_dir=out, hist_every=2,
                   ckpt_every=2)
    save_checkpoint(os.path.join(out, "final"), final,
                    {"nstep": int(final.nstep)})
    paths, _ = jax.tree_util.tree_flatten_with_path(final)
    with open(os.path.join(out, "leaf_names.json"), "w") as f:
        json.dump([jax.tree_util.keystr(p) for p, _ in paths], f)


if __name__ == "__main__":
    main(sys.argv[1])
