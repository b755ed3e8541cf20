"""The port's Data on multi-node clusters (``ray_tpu_torch.cluster_utils``):
tests/test_data_breadth.py's tokenized-text ingest under a NodeKiller, and
tests/test_data_shuffle.py's 2-node exchange smoke with a real node agent.
Each test starts its own Cluster."""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch.data import executor as dx
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@deadline(300)
def test_tokenized_text_ingest_survives_chaos(tmp_path):
    """The pretraining ingest shape: read_text -> tokenize in
    map_batches -> streaming_split consumed from worker processes while
    a NodeKiller removes nodes. Every document must arrive exactly once
    per the split contract (blocks are retried via lineage)."""
    from ray_tpu_torch.cluster_utils import Cluster, NodeKiller

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        for _ in range(3):
            cluster.add_node(num_cpus=2)
        n_docs, seq = 64, 16
        for shard in range(8):
            with open(tmp_path / f"docs-{shard}.txt", "w") as f:
                for i in range(n_docs // 8):
                    doc_id = shard * (n_docs // 8) + i
                    f.write(f"doc {doc_id} " + "tok " * (doc_id % 9) + "\n")

        def tokenize(batch):
            # toy byte-level tokenizer padded to a fixed train shape
            ids = np.zeros((len(batch["text"]), seq), np.int32)
            doc = np.zeros(len(batch["text"]), np.int32)
            for r, text in enumerate(batch["text"]):
                raw = [1 + (b % 250) for b in str(text).encode()][:seq]
                ids[r, :len(raw)] = raw
                doc[r] = int(str(text).split()[1])
            return {"input_ids": ids, "doc_id": doc}

        ds = data.read_text(str(tmp_path)).map_batches(tokenize,
                                                       batch_size=8)
        it1, it2 = ds.streaming_split(2)

        @ray_tpu_torch.remote(max_retries=-1)
        def consume(it):
            seen = []
            for b in it.iter_batches(batch_size=4):
                ids = np.asarray([np.asarray(row)
                                  for row in b["input_ids"]])
                assert ids.shape[1] == seq
                seen.extend(int(d) for d in b["doc_id"])
            return seen

        killer = NodeKiller(cluster, interval_s=(0.2, 0.5), max_kills=2,
                            seed=7, protect=(0,)).start()
        try:
            got1, got2 = ray_tpu_torch.get(
                [consume.remote(it1), consume.remote(it2)], timeout=300)
        finally:
            killer.stop()
        assert killer.error is None
        assert sorted(got1 + got2) == list(range(n_docs))
    finally:
        cluster.shutdown()


@deadline(300)
def test_shuffle_2node_prefetch_smoke():
    """Tier-1 exchange smoke on a REAL 2-node cluster: parts move
    store-to-store, merge-side dispatch hints reach the prefetch
    machinery (prefetch_issued > 0), and
    random_shuffle().iter_batches() returns exactly the input multiset
    of rows."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    handle = None
    try:
        handle = cluster.add_remote_node(num_cpus=2)
        import ray_tpu_torch.core.api as core_api

        head = core_api._head
        issued0 = head.prefetch_issued
        n = 4000
        pad = np.zeros(64, np.uint8)

        def fatten(b):
            return {"id": b["id"],
                    "pad": np.stack([pad] * len(b["id"]))}

        ds = data.range(n, parallelism=8).map_batches(fatten) \
            .random_shuffle(seed=5)
        seen = []
        for b in ds.iter_batches(batch_size=512, batch_format="numpy"):
            seen.extend(int(v) for v in b["id"])
        assert sorted(seen) == list(range(n))
        # merge args are by-ref plasma parts; at least one merge landed
        # on a node missing parts, so the dispatch-time hint fired a
        # speculative pull
        assert head.prefetch_issued - issued0 >= 1
        assert dx.SHUFFLE_STATS["exchanges"] >= 1
    finally:
        if handle is not None:
            handle.terminate()
        cluster.shutdown()
