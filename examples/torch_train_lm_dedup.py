"""End-to-end training example on the PyTorch port: a small qwen3-family LM
trained on the synthetic corpus with bloomRF online dedup + shard
range-admission, sharded checkpoints (with bloomRF layer-range indexes),
a fault-injected restart under the Supervisor, and straggler monitoring.
The port's twin of examples/train_lm_dedup.py.

    PYTHONPATH=src python examples/torch_train_lm_dedup.py [--steps 60]
    PYTHONPATH=src python examples/torch_train_lm_dedup.py --device cpu

On a CUDA device the filters run the insert, point and range kernels.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import StreamDeduper, SyntheticCorpus, batch_iterator
from repro_torch.models import get_model
from repro_torch.train import OptConfig, TrainConfig, Trainer
from repro_torch.train.checkpoint import latest_step, restore_layer_range
from repro_torch.train.fault_tolerance import Supervisor


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    cfg = get_config("qwen3-1.7b", smoke=True)
    ckpt_dir = tempfile.mkdtemp(prefix="bloomrf_train_")
    dedup = StreamDeduper(expected_docs=1 << 14, device=device)

    def data():
        corpus = SyntheticCorpus(vocab=cfg.vocab, seed=1, dup_rate=0.3)
        return batch_iterator(corpus, args.batch, args.seq, deduper=dedup,
                              window=(0, 10_000), device=device)

    def factory():
        model = get_model(cfg, device)
        params = model.init(torch.Generator(device).manual_seed(0))
        return Trainer(
            model, params,
            OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
            TrainConfig(steps=args.steps, checkpoint_every=20, log_every=10,
                        grad_compression=True),
            data(), ckpt_dir=ckpt_dir,
            fail_at_step=args.steps // 2
            if latest_step(ckpt_dir) is None else None)

    sup = Supervisor(factory, max_restarts=2)
    res = sup.run()
    print(f"\ntrained {args.steps} steps with {res['restarts']} restart(s) "
          f"on {device}")
    for rec in res["metrics"]:
        print(f"  step {rec['step']:4d} loss {rec['loss']:.4f} "
              f"lr {rec['lr']:.2e} {rec['step_time_s']*1e3:.0f} ms")
    print("dedup stats:", dedup.stats)
    print("straggler events:", res["stragglers"])

    # elastic partial restore: a 'pipeline stage' pulling layers [0, 0]
    step = latest_step(ckpt_dir)
    part, probed, loaded = restore_layer_range(ckpt_dir, step, 0, 0,
                                               device=device)
    print(f"layer-range restore via bloomRF index: {loaded}/{probed} shards "
          f"loaded, {len(part)} leaf slices")


if __name__ == "__main__":
    main()
