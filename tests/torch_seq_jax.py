"""The JAX package's references of `tests/test_torch_seq_parallel.py` that
take longest to compile, run in processes of their own beside the ranks:
`python tests/torch_seq_jax.py OUT PART` pickles part PART ("loss",
"ring_data" or "ring_expert") to OUT/jax_PART.pkl.

  * "loss": `loss_fn` with and without its ring over four devices (the
    loss and the gradients, numpy, JAX layout), and JAX's `Trainer` on a
    (2, 2, 1) mesh taking two steps on a batch of 3 rows, which it
    replicates (the metric rows);
  * "ring_data", "ring_expert": JAX's `Trainer` with ring attention over
    the data axis of (2, 1, 2) or the expert axis of (1, 2, 2) beside tensor
    parallelism on model (the metric rows).
"""

import dataclasses
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tests import torch_seq_cases as C  # noqa: E402
from unimoe_audio_torch.core.bridge import params_to_numpy  # noqa: E402


def _jparams(cfg):
    return jax.tree.map(jnp.asarray, params_to_numpy(C.port_params(cfg)))


def loss_refs():
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.train.step import loss_fn

    seq = Mesh(np.asarray(jax.devices()[:C.WORLD]), ("seq",))
    cfg = C.loss_config(jax_tiny)
    params = _jparams(cfg)
    batch = {k: jnp.asarray(v) for k, v in C.loss_batch(cfg).items()}
    out = {}
    for name, ring in (("plain", None), ("ring", (seq, "seq"))):
        f = jax.jit(jax.value_and_grad(lambda p, b, ring=ring: loss_fn(
            p, cfg, b, jax.random.PRNGKey(1), jnp.float32(0.025), remat=False, ring=ring)[0]))
        loss, grads = f(params, batch)
        out[("ring_loss", name)] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def _fit(shape, rows=None, **kw):
    """JAX's Trainer on a mesh of `shape`, the weights tensor-parallel over
    model (`shard_params`), two steps on `train_batch` (its first `rows`
    rows): the metric rows."""
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.parallel import mesh as JMESH
    from unimoe_audio_tpu.train.trainer import Trainer, TrainerConfig

    cfg = C.train_config(make=jax_tiny)
    t = C.trainer_config()
    fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), JMESH.AXES)
    tr = Trainer(cfg, JMESH.shard_params(_jparams(cfg), mesh, cfg),
                 TrainerConfig(**{**fields, **kw}), mesh=mesh)
    b = C.train_batch(cfg)
    b = b if rows is None else {k: v[:rows] for k, v in b.items()}
    return tr.fit([b, b])


PARTS = {"loss": loss_refs,
         "replicated": lambda: {"replicated": _fit(C.REPLICATED_MESH, C.REPLICATED_ROWS)},
         **{f"ring_{case[1]}": (lambda case=case: {("ring_train", case): _fit(
             case[0], ring_axis=case[1])}) for case in C.RING_JAX_CASES}}


def main(out: str, part: str) -> int:
    with open(os.path.join(out, f"jax_{part}.pkl"), "wb") as f:
        pickle.dump(PARTS[part](), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
