"""One rank of a gloo group on the CPU, for tests/test_torch_parallel.py.

    python tests/torch_ranks.py JOB_FILE RANK

JOB_FILE is a pickle the test wrote: {"world": n, "store": path, "jobs":
[...], "launcher": bool}; with "launcher" the rank joins its group with
parallel.multihost.initialize_distributed() and no arguments, from the
MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE the test set in its
environment, as torchrun sets them; else over the file:// store. Each job
is one of
  ("sharded", kwargs, static)           parallel.mesh.sharded_decode on
                                        make_mesh(n), on the CPU
  ("multihost", frames, dict_bytes, tiny)
                                        parallel.multihost.
                                        decode_frames_multihost with a CPU
                                        BatchDecoder (the dictionary
                                        registered, under
                                        utils.caps.tiny_caps() when tiny)
  ("report", frames)                    scaling_report on the CPU
  ("mesh_size", m)                      make_mesh(m): the error it raises
  ("stage_mesh", frames)                BatchDecoder.stage(batch,
                                        mesh=make_mesh(n)): the error it
                                        raises
The rank writes its results, in job order, to JOB_FILE.RANK.out (a pickle),
after process_info() outside and inside the group. It imports torch and
zstd_tpu_torch only, never jax or zstd_tpu.
"""

import contextlib
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(job_file: str, rank: int) -> None:
    import torch.distributed as dist

    from zstd_tpu_torch.models.batch_decoder import BatchDecoder
    from zstd_tpu_torch.parallel import multihost
    from zstd_tpu_torch.parallel.mesh import make_mesh, sharded_decode
    from zstd_tpu_torch.utils.caps import tiny_caps

    with open(job_file, "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    results = {"outside": multihost.process_info()}
    url = f"file://{spec['store']}"
    if spec.get("launcher"):
        multihost.initialize_distributed()
    elif world == 1:  # initialize_distributed is a no-op for one process
        dist.init_process_group("gloo", init_method=url, world_size=1,
                                rank=0)
    else:
        multihost.initialize_distributed(url, world, rank)
    results["inside"] = multihost.process_info()
    out = []
    for job in spec["jobs"]:
        if job[0] == "sharded":
            out.append(sharded_decode(job[1], job[2], make_mesh(world),
                                      device="cpu"))
        elif job[0] == "multihost":
            _, frames, dict_bytes, tiny = job
            with tiny_caps() if tiny else contextlib.nullcontext():
                dec = BatchDecoder(device="cpu")
                if dict_bytes is not None:
                    dec.add_dict(dict_bytes)
                out.append(multihost.decode_frames_multihost(frames, dec))
        elif job[0] == "report":
            out.append(multihost.scaling_report(
                job[1], decoder=BatchDecoder(device="cpu")))
        elif job[0] == "mesh_size":
            try:
                make_mesh(job[1])
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        elif job[0] == "stage_mesh":
            dec = BatchDecoder(device="cpu")
            try:
                dec.stage(dec.prepare(job[1]), mesh=make_mesh(world))
                out.append(None)
            except TypeError as e:
                out.append(str(e))
    results["jobs"] = out
    dist.destroy_process_group()
    with open(f"{job_file}.{rank}.out", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]))
