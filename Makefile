# kubeshare-tpu build surface (ref Makefile:1-20: per-component binaries +
# container images; here one native build + one image).
#
#   make native          build tokend/pmgr/client/shim into native/build
#   make test            run the test suite (CPU mesh)
#   make serve-smoke     continuous-batching serving bench, fast CPU path
#   make serve-prefix-smoke  prefix-cache on/off serving bench, fast CPU path
#   make serve-qos-smoke multi-tenant QoS serving bench, fast CPU path
#   make serve-mixed-smoke  stall-free mixed batching on/off bench, fast CPU path
#   make serve-tier-smoke   host-RAM KV tier on/off bench, fast CPU path
#   make serve-spec-smoke   speculative decoding on/off bench, fast CPU path
#   make serve-disagg-smoke disaggregated prefill/decode bench, fast CPU path
#   make serve-sharded-smoke tensor-parallel sharded serving bench, fast CPU path
#   make serve-loop-smoke   device-resident multi-step loop bench, fast CPU path
#   make serve-loop-v2-smoke  verify-in-loop + admission ring bench, fast CPU path
#   make serve-fleet-smoke  replica-fleet routing bench, fast CPU path
#   make serve-autotune-smoke  cost-model autotuner bench, fast CPU path
#   make serve-chaos-smoke  fault-injection fleet recovery bench, fast CPU path
#   make serve-fabric-smoke cluster KV fabric cross-process bench, fast CPU path
#   make images          build the kubeshare-tpu:latest container image
#   make image-check     validate everything the Dockerfile needs, sans docker
#   make e2e-kind        kind-based end-to-end (skips cleanly without kind)
#   make images-torch    build the port's kubeshare-tpu-torch:latest image
#   make image-check-torch  validate everything docker/Dockerfile.torch needs, sans docker
#   make e2e-kind-torch  the port's kind end-to-end (skips cleanly without kind)

IMAGE ?= kubeshare-tpu:latest
IMAGE_TORCH ?= kubeshare-tpu-torch:latest
DOCKER ?= $(shell command -v docker || command -v podman)

.PHONY: all native test serve-smoke serve-prefix-smoke serve-qos-smoke serve-mixed-smoke serve-tier-smoke serve-spec-smoke serve-disagg-smoke serve-sharded-smoke serve-loop-smoke serve-loop-v2-smoke serve-fleet-smoke serve-autotune-smoke serve-chaos-smoke serve-fabric-smoke images image-check e2e-kind images-torch image-check-torch e2e-kind-torch tsan clean

all: native

native:
	$(MAKE) -C native

tsan:
	$(MAKE) -C native tsan

test:
	python3 -m pytest tests/ -x -q

serve-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --smoke

serve-prefix-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --shared-prefix --smoke

serve-qos-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --multi-tenant --smoke

serve-mixed-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --mixed --smoke

serve-tier-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --tiered --smoke

serve-spec-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --speculative --smoke

serve-disagg-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --disagg --smoke

serve-sharded-smoke:
	XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --sharded --smoke

serve-loop-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --device-loop --smoke

serve-loop-v2-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --device-loop --speculative --smoke

serve-fleet-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --fleet --smoke

serve-autotune-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --autotune --smoke

serve-chaos-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --chaos --smoke

serve-fabric-smoke:
	JAX_PLATFORMS=cpu python3 benchmarks/serving_bench.py --fabric --smoke

images: image-check
ifeq ($(strip $(DOCKER)),)
	@echo "error: neither docker nor podman found; cannot build $(IMAGE)." >&2
	@echo "image-check passed: the build context is complete — run" >&2
	@echo "  docker build -f docker/Dockerfile -t $(IMAGE) ." >&2
	@echo "on a machine with a container runtime." >&2
	@exit 1
else
	$(DOCKER) build -f docker/Dockerfile -t $(IMAGE) .
endif

# Everything `docker build` will need, verifiable on container-less hosts:
# the native build (hermetic, vendored PJRT header) and every path the
# Dockerfile COPYs / the manifests reference.
image-check: native
	@test -f native/build/libtpushim.so.1 || { echo "missing libtpushim.so.1"; exit 1; }
	@test -f native/build/libtpushare_client.so
	@test -x native/build/tpushare-tokend
	@test -x native/build/tpushare-pmgr
	@test -f docker/Dockerfile
	@test -d kubeshare_tpu -a -d examples -a -d deploy/config
	@python3 -c "import kubeshare_tpu"
	@python3 -c "import kubeshare_tpu.cli as c; subs = c.build_parser()._subparsers._group_actions[0].choices; missing = {'collector','aggregator','configd','launcher','scheduler','simulate'} - set(subs); assert not missing, 'cli missing subcommands %s' % missing"
	@echo "image-check: ok (context complete for $(IMAGE))"

e2e-kind:
	deploy/e2e-kind.sh

images-torch: image-check-torch
ifeq ($(strip $(DOCKER)),)
	@echo "error: neither docker nor podman found; cannot build $(IMAGE_TORCH)." >&2
	@echo "image-check-torch passed: the build context is complete — run" >&2
	@echo "  docker build -f docker/Dockerfile.torch -t $(IMAGE_TORCH) ." >&2
	@echo "on a machine with a container runtime." >&2
	@exit 1
else
	$(DOCKER) build -f docker/Dockerfile.torch -t $(IMAGE_TORCH) .
endif

# Everything `docker build -f docker/Dockerfile.torch` needs, verifiable on
# container-less hosts: tokend and pmgr, the driver interposer (g++), every
# path the Dockerfile copies, and the port's subcommands.
image-check-torch:
	$(MAKE) -C native build/tpushare-tokend build/tpushare-pmgr
	@python3 deploy/cuda/image_check.py $(IMAGE_TORCH)

e2e-kind-torch:
	deploy/cuda/e2e-kind.sh

clean:
	$(MAKE) -C native clean
