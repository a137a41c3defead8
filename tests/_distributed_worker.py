"""Worker process for the multi-process jax.distributed test.

Launched by tests/test_distributed.py as
``python _distributed_worker.py <process_id> <num_processes> <port>``.
Forces the CPU platform in-process (two processes must not both open an
accelerator), initializes the distributed runtime over localhost TCP
through the library wrapper, and prints assertion markers the parent
checks.
"""

import os
import sys


def main() -> None:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        # Cross-process CPU collectives (gloo); older jax builds lack the
        # option — initialization itself is still exercised then.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from mlx_mcmc_tpu.parallel import initialize_distributed

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )

    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.process_index() == process_id
    local = len(jax.local_devices())
    total = len(jax.devices())
    assert total == num_processes * local, (total, local)
    print(f"INIT_OK pid={process_id} local={local} global={total}", flush=True)

    # Best effort: a global psum across both processes' devices.
    try:
        import numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(jax.devices()), ("x",))
        sharding = NamedSharding(mesh, P("x"))
        global_shape = (total,)
        local_vals = np.asarray(
            [float(d.id) for d in jax.local_devices()], np.float32
        )
        arr = jax.make_array_from_process_local_data(
            sharding, local_vals, global_shape
        )
        total_sum = jax.jit(
            lambda x: jax.numpy.sum(x), out_shardings=NamedSharding(mesh, P())
        )(arr)
        expected = float(sum(d.id for d in jax.devices()))
        got = float(np.asarray(total_sum.addressable_shards[0].data))
        assert got == expected, (got, expected)
        print(f"PSUM_OK pid={process_id} sum={got}", flush=True)
    except Exception as e:  # pragma: no cover - depends on jax build
        print(f"PSUM_SKIP pid={process_id} reason={type(e).__name__}: {e}",
              flush=True)

    jax.distributed.shutdown()
    print(f"DONE pid={process_id}", flush=True)


if __name__ == "__main__":
    main()
