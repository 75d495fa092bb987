"""Self-launching 2-process distributed render demo.

Run with no arguments: the script relaunches itself as 2 worker processes
(the pattern of a real multi-host job, one process per host), each
joining a `jax.distributed` runtime. Every process executes the same
global shard_map render over the global mesh; pixel shards host-gather to
process 0, which writes the image.

Both workers stay on the CPU (JAX_PLATFORMS=cpu, 2 virtual devices each)
even on a GPU host, and the collectives run over Gloo: two JAX processes
opening the same card would each try to reserve most of its memory. On a
multi-host GPU cluster the identical code runs one process per host, each
on its own cards, with the collectives over NCCL.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import socket
import subprocess
import sys

N_PROCESSES = 2
SIZE = 64


def launch() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {
        **os.environ,
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(N_PROCESSES),
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_PLATFORMS": "cpu",
    }
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker"],
                         env={**env, "JAX_PROCESS_ID": str(i)})
        for i in range(N_PROCESSES)
    ]
    return max(p.wait() for p in procs)


def worker() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from nerf_rs_tpu.config import RenderConfig
    from nerf_rs_tpu.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu.io.image import save_png
    from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu.parallel import multihost

    assert multihost.initialize(), "distributed runtime failed to start"
    pid = jax.process_index()
    print(f"[proc {pid}] {jax.process_count()} processes, "
          f"{jax.local_device_count()} local / {jax.device_count()} global devices")

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    img = multihost.render_image_multihost(
        load_nerf_params(assets / "coarse"), load_nerf_params(assets / "fine"),
        camera, SIZE, SIZE, jax.random.key(0),
        RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024),
    )
    if img is not None:   # process 0 only
        save_png("lego_multihost.png", np.asarray(img), SIZE, SIZE)
        print(f"[proc {pid}] wrote lego_multihost.png")
    return 0


if __name__ == "__main__":
    sys.exit(worker() if "--worker" in sys.argv else launch())
