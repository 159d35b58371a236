# Local automation gate — `make check` is the pre-commit bar (a red suite
# must not be committed).  CI (.github/workflows/ci.yml)
# runs the same targets.

PY ?= python

.PHONY: check test test-fast bench-small native workflow-smoke clean

check: native test bench-small workflow-smoke

# -n 2 (pytest-xdist) shards tests across worker PROCESSES: one process
# accumulating the whole suite's ~150 XLA:CPU executables eventually
# segfaults inside the native compiler (see tests/conftest.py note);
# sharding keeps per-process JIT state bounded and uses both cores.
test:
	$(PY) -m pytest tests/ -q -n 2

# skips the two slowest suites (multi-process distributed + parallel tree)
test-fast:
	$(PY) -m pytest tests/ -q -n 2 --ignore=tests/test_distributed.py \
	    --ignore=tests/test_parallel_tree.py

bench-small:
	env JAX_PLATFORMS=cpu $(PY) bench.py --small

native:
	$(MAKE) -C codex_storage_proofs_circuits_tpu/native

workflow-smoke:
	cd $${TMPDIR:-/tmp} && rm -rf cspc_wf_smoke && mkdir cspc_wf_smoke && \
	cd cspc_wf_smoke && \
	env JAX_PLATFORMS=cpu NCELLS=64 NSLOTS=5 CELLSIZE=256 BLOCKSIZE=4096 \
	    BACKEND=oracle bash $(CURDIR)/workflow/setup.sh && \
	env JAX_PLATFORMS=cpu NCELLS=64 NSLOTS=5 CELLSIZE=256 BLOCKSIZE=4096 \
	    BACKEND=oracle bash $(CURDIR)/workflow/prove.sh

clean:
	rm -rf build dist *.egg-info
	$(MAKE) -C codex_storage_proofs_circuits_tpu/native clean 2>/dev/null || true
