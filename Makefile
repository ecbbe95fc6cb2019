# Developer entry points, mirroring the reference Makefile's targets
# (reference Makefile:14-34: all/check/profile/debug) in framework form.

PY ?= python
DECK ?= 128x128
OUT ?= out

.PHONY: all test test-all test-gpu check run bench native clean profile

all: native

# Build the native IO runtime explicitly (it also builds lazily on demand).
native:
	mkdir -p native/build
	g++ -O2 -std=c++17 -shared -fPIC native/io_native.cpp -o native/build/libtpulbm_io.so

# Default gate on the CPU (8 virtual devices): everything except the
# `slow` tests (multi-process, 4096^2 grids). Full matrix: test-all.
test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m "not slow"

test-all:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

# Tests that need an NVIDIA GPU (marker `gpu`); run on a machine with one.
test-gpu:
	JAX_PLATFORMS=cuda $(PY) -m pytest tests/ -q -m gpu

run:
	$(PY) -m tpulbm data/input_$(DECK).params data/obstacles_$(DECK).dat --out-dir $(OUT)

# Golden regression gate — the reference's `make check` (Makefile:19-20).
# The 256x256 / 1024x1024 final_state goldens are stripped upstream
# (reference .MISSING_LARGE_BLOBS); those decks gate against the
# framework-generated f64-oracle pressure goldens (.f64.npz,
# scripts/make_f64_goldens.py) so all four decks are final-state-gated.
check: run
	@if [ -f tests/goldens/$(DECK).final_state.dat ]; then \
	  $(PY) -m tpulbm.validation.check \
	    --ref-av-vels-file tests/goldens/$(DECK).av_vels.dat \
	    --ref-final-state-file tests/goldens/$(DECK).final_state.dat \
	    --av-vels-file $(OUT)/av_vels.dat \
	    --final-state-file $(OUT)/final_state.dat; \
	elif [ -f tests/goldens/$(DECK).final_state.f64.npz ]; then \
	  echo "final_state golden for $(DECK) stripped upstream;" \
	       "gating against the framework f64-oracle pressure golden"; \
	  $(PY) -m tpulbm.validation.check \
	    --ref-av-vels-file tests/goldens/$(DECK).av_vels.dat \
	    --ref-final-state-file tests/goldens/$(DECK).final_state.f64.npz \
	    --av-vels-file $(OUT)/av_vels.dat \
	    --final-state-file $(OUT)/final_state.dat; \
	else \
	  echo "no final_state golden for $(DECK); av_vels-only gate"; \
	  $(PY) -m tpulbm.validation.check --av-vels-only \
	    --ref-av-vels-file tests/goldens/$(DECK).av_vels.dat \
	    --av-vels-file $(OUT)/av_vels.dat; \
	fi

bench:
	$(PY) bench.py --grid $(DECK)

# Capture a jax.profiler trace of the step loop — the `make profile` equivalent
# (reference Makefile:30-31 + MPI_Pcontrol brackets).
profile:
	$(PY) -m tpulbm data/input_$(DECK).params data/obstacles_$(DECK).dat \
	  --out-dir $(OUT) --profile-dir $(OUT)/trace --no-output

clean:
	rm -rf $(OUT) native/build __pycache__ tpulbm/**/__pycache__ .pytest_cache .jax_cache
