"""vrod-tpu quickstart over the PyTorch/CUDA port: build a small semantic
word index and query it. The program of ``examples/quickstart.py``, over
``vrod_tpu_torch``; it prints the same lines.

Runs on the GPU (``cuda:0``), or on the CPU with ``VROD_PLATFORM=cpu``:

    python examples/torch_quickstart.py
"""

import tempfile

import numpy as np

from vrod_tpu_torch import Database
from vrod_tpu_torch.utils.embeddings import hash_embed
from vrod_tpu_torch.utils.verify import verify_recall

WORDS = [
    "apple", "apricot", "banana", "cherry", "grape", "lemon", "mango",
    "car", "truck", "bicycle", "train", "airplane", "boat",
    "red", "green", "blue", "yellow", "purple",
]


def main():
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.new(tmp, "quickstart")
        col = db.create_collection("words", dim=384, metric="cosine")

        vectors = hash_embed(WORDS)
        ids = col.bulk_insert(vectors, WORDS)
        print(f"Inserted {len(ids)} records")

        for probe in ("apple", "bicycle", "green"):
            q = hash_embed([probe])[0]
            hits = col.search_similar(q, k=4)
            neighbors = ", ".join(
                f"{h.payload} ({h.score:.3f})" for h in hits)
            print(f"  {probe:>8} -> {neighbors}")

        # Filtered search: exact top-k of an id subset (allow/deny lists
        # become device masks; no recompilation, no throughput cost).
        fruit_ids = ids[:7]
        q = hash_embed(["citrus"])[0]
        hits = col.search_similar(q, k=3, within_ids=fruit_ids)
        print("  citrus within fruits ->",
              ", ".join(h.payload for h in hits))

        # Mutations + durability round trip.
        col.update(int(ids[0]), hash_embed(["pineapple"])[0], "pineapple")
        col.delete(int(ids[1]))
        col.snapshot()
        db.close()

        db2 = Database.load(f"{tmp}/quickstart")
        col2 = db2.collection("words")
        print(f"Reloaded: {col2.count} records "
              f"(recall check: {verify_recall(col2, hash_embed(['fruit']), k=5)})")
        db2.close()


if __name__ == "__main__":
    main()
