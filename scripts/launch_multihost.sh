#!/usr/bin/env bash
# Multi-host launcher — the counterpart of the reference's PBS submit script
# (mpi_submit:1-64) and environment file (env.sh:4-9).
#
# On a cluster whose scheduler jax.distributed recognises (e.g. SLURM), run
# the SAME command on every host; jax.distributed detects the coordinator and
# process ids:
#
#   scripts/launch_multihost.sh data/input_4096x4096.params \
#                               data/obstacles_4096x4096.dat --out-dir out
#
# On unmanaged clusters set the process-group env explicitly per host:
#
#   TPULBM_COORDINATOR=host0:9876 TPULBM_NUM_PROCS=4 TPULBM_PROC_ID=$i \
#       scripts/launch_multihost.sh ...
#
# A local smoke mode (no accelerator needed) runs N processes x M virtual CPU
# devices on one machine — the same path the multi-process test uses:
#
#   scripts/launch_multihost.sh --local-smoke 2x4 data/input_128x128.params \
#                               data/obstacles_128x128.dat --out-dir /tmp/mh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

if [[ "${1:-}" == "--local-smoke" ]]; then
    shape="$2"; shift 2
    procs="${shape%x*}"; devs="${shape#*x}"
    port=$(( 20000 + RANDOM % 20000 ))
    pids=()
    for ((i = 0; i < procs; i++)); do
        TPULBM_COORDINATOR="localhost:$port" \
        TPULBM_NUM_PROCS="$procs" TPULBM_PROC_ID="$i" \
        JAX_PLATFORMS=cpu \
        XLA_FLAGS="--xla_force_host_platform_device_count=$devs" \
            python -m tpulbm "$@" --multihost &
        pids+=($!)
    done
    rc=0
    for p in "${pids[@]}"; do wait "$p" || rc=$?; done
    exit "$rc"
fi

exec python -m tpulbm "$@" --multihost
