"""Everything ``docker build -f docker/Dockerfile.torch`` needs, checked on
a host without a container runtime: every path the Dockerfile copies
exists, the driver interposer builds with g++ (as the image's build step
builds it), and the port's CLI has the six subcommands the manifests run.

    python3 deploy/cuda/image_check.py [IMAGE]     (make image-check-torch)

Run from the root of the repo, after ``make -C native`` has built
tpushare-tokend and tpushare-pmgr.
"""

import glob
import os
import sys

DOCKERFILE = "docker/Dockerfile.torch"
SUBCOMMANDS = {"collector", "aggregator", "configd", "launcher", "scheduler",
               "simulate"}
BINARIES = ("native/build/tpushare-tokend", "native/build/tpushare-pmgr")


def copied_paths(text: str) -> list:
    """The build-context sources of the Dockerfile's COPY instructions."""
    sources = []
    for line in text.replace("\\\n", " ").splitlines():
        words = line.split()
        if not words or words[0] != "COPY":
            continue
        if any(w.startswith("--from") for w in words):
            continue  # a copy between stages, not from the context
        sources += [w for w in words[1:-1] if not w.startswith("--")]
    return sources


def main(argv) -> int:
    image = argv[1] if len(argv) > 1 else "kubeshare-tpu-torch:latest"
    with open(DOCKERFILE) as f:
        sources = copied_paths(f.read())
    missing = [s for s in sources if not glob.glob(s)]
    assert sources and not missing, f"{DOCKERFILE} copies missing {missing}"
    for binary in BINARIES:
        assert os.access(binary, os.X_OK), f"missing {binary}"
    sys.path.insert(0, ".")
    from kubeshare_tpu_torch import cli
    from kubeshare_tpu_torch.isolation.hook import hook_path

    print(f"image-check-torch: hook {hook_path()}")
    choices = cli.build_parser()._subparsers._group_actions[0].choices
    missing = SUBCOMMANDS - set(choices)
    assert not missing, f"cli missing subcommands {missing}"
    print(f"image-check-torch: ok (context complete for {image}: "
          f"{len(sources)} copied paths, {len(SUBCOMMANDS)} subcommands)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
