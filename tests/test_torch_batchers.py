"""The port's buffered batchers (``ops/batchers.py``) and the default
hyperparameter tables under the contracts ``tests/test_batchers.py``
holds the JAX package's to (slow and fast consumers, remainders, errors
from the source, close and end-of-stream)."""

import time

import numpy as np

from synapseml_tpu_torch.automl import DefaultHyperparams
from synapseml_tpu_torch.models.gbdt.estimators import GBDTClassifier
from synapseml_tpu_torch.models.online import OnlineSGDRegressor
from synapseml_tpu_torch.ops import (DynamicBufferedBatcher, FixedBufferedBatcher,
                               TimeIntervalBatcher)
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


class TestDynamicBufferedBatcher:
    def test_all_items_delivered_once(self):
        items = list(range(1000))
        got = [x for batch in DynamicBufferedBatcher(iter(items))
               for x in batch]
        assert got == items

    def test_slow_consumer_gets_larger_batches(self):
        def trickle():
            for i in range(50):
                time.sleep(0.001)
                yield i

        b = DynamicBufferedBatcher(trickle())
        first = b.__next__()
        time.sleep(0.02)            # let the producer run ahead
        second = b.__next__()
        rest = [x for batch in b for x in batch]
        assert len(second) > 1      # accumulated while we slept
        assert sorted(first + second + rest) == list(range(50))

    def test_empty_source(self):
        assert list(DynamicBufferedBatcher(iter([]))) == []


class TestFixedBufferedBatcher:
    def test_fixed_sizes_with_remainder(self):
        batches = list(FixedBufferedBatcher(iter(range(10)), batch_size=4))
        assert [len(b) for b in batches] == [4, 4, 2]
        assert [x for b in batches for x in b] == list(range(10))


class TestTimeIntervalBatcher:
    def test_flushes_and_caps_batch_size(self):
        b = TimeIntervalBatcher(iter(range(100)), interval_ms=5,
                                max_batch_size=30)
        batches = list(b)
        assert all(len(x) <= 30 for x in batches)
        assert sorted(x for bt in batches for x in bt) == list(range(100))


class TestDefaultHyperparams:
    def test_gbdt_table(self):
        entries = DefaultHyperparams.for_stage(GBDTClassifier(device="cpu"))
        assert {e[1] for e in entries} >= {"numIterations", "learningRate",
                                           "numLeaves"}

    def test_online_table(self):
        entries = DefaultHyperparams.for_stage(OnlineSGDRegressor(device="cpu"))
        assert {e[1] for e in entries} >= {"learningRate", "numPasses"}


class TestProducerErrorPropagation:
    def test_fixed_batcher_reraises_source_error(self):
        import pytest
        from synapseml_tpu_torch.ops.batchers import FixedBufferedBatcher

        def flaky():
            yield 1
            yield 2
            raise RuntimeError("source died")

        b = FixedBufferedBatcher(flaky(), batch_size=2)
        assert next(b) == [1, 2]
        with pytest.raises(RuntimeError, match="source died"):
            next(b)

    def test_dynamic_batcher_reraises_source_error(self):
        import pytest
        from synapseml_tpu_torch.ops.batchers import DynamicBufferedBatcher

        def flaky():
            raise RuntimeError("immediate")
            yield  # pragma: no cover

        with pytest.raises(RuntimeError, match="immediate"):
            next(DynamicBufferedBatcher(flaky()))

    def test_close_unblocks_full_queue_producer(self):
        import itertools
        from synapseml_tpu_torch.ops.batchers import FixedBufferedBatcher

        b = FixedBufferedBatcher(itertools.count(), batch_size=1,
                                 max_buffer_size=2)
        assert next(b) == [0]
        b.close()                      # producer parked on full queue
        assert not b._thread.is_alive()

    def test_sentinel_survives_busy_consumer(self):
        """Producer finishing while the queue is full must still deliver
        end-of-stream once the consumer catches up (no dropped sentinel)."""
        import time
        from synapseml_tpu_torch.ops.batchers import FixedBufferedBatcher

        b = FixedBufferedBatcher(iter(range(6)), batch_size=2,
                                 max_buffer_size=2)
        assert next(b) == [0, 1]
        time.sleep(0.3)            # producer hits full queue + exhausts src
        rest = list(b)             # must terminate, not hang
        assert rest == [[2, 3], [4, 5]]

    def test_lost_sentinel_falls_back_to_finished_flag(self):
        """Even if _put_sentinel gave up (30s saturated-queue timeout), a
        consumer draining the queue later must see end-of-stream via the
        producer-finished flag, not block forever (advisor finding,
        round 1)."""
        from synapseml_tpu_torch.ops.batchers import FixedBufferedBatcher

        b = FixedBufferedBatcher(iter(range(4)), batch_size=2,
                                 max_buffer_size=2)
        assert next(b) == [0, 1]
        b._thread.join(timeout=5.0)
        # simulate the give-up path: strip the sentinel the producer
        # managed to enqueue, leaving only real batches + finished flag
        items = []
        while not b._queue.empty():
            it = b._queue.get_nowait()
            if not isinstance(it, list):
                continue
            items.append(it)
        for it in items:
            b._queue.put(it)
        assert next(b) == [2, 3]
        import pytest
        with pytest.raises(StopIteration):
            b.__next__()
