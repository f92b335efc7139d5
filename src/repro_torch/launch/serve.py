"""Serving launcher, as ``repro.launch.serve``: batched greedy decoding
with request padding and slot reuse.

Requests arrive with different prompt lengths; the server packs them into
a fixed batch of decode slots, prefilling token by token (the same
serve_step as generation) and emitting completions wave by wave.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --requests 12 --batch 4 --gen 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)


class BatchedServer:
    """Fixed-slot batched decoder (one shared KV cache, shared pos), on
    ``device`` (None: the card), where ``params`` must lie."""

    def __init__(self, cfg, params, batch: int, cache_len: int, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, server on "
                             f"{self.device}")
        self.cfg, self.params, self.b = cfg, params, batch
        self.cache_len = cache_len
        self.cache = self._empty_cache()
        self.step = make_serve_step(cfg)

    def _empty_cache(self) -> dict:
        return T.init_cache(self.cfg, self.b, self.cache_len,
                            dtype=torch.float32, device=self.device)

    def _decode(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        logits, self.cache = self.step(self.params, self.cache,
                                       {"tokens": tokens, "pos": pos})
        return torch.argmax(logits[:, -1], -1)[:, None]

    def run(self, requests: list[Request]) -> dict:
        """Serve requests in arrival order with slot packing.

        Decoding is lockstep across slots (shared pos): requests are
        packed in waves, as in the reference."""
        done: list[Request] = []
        t0 = time.perf_counter()
        steps = 0
        queue = list(requests)
        while queue:
            wave = queue[: self.b]
            queue = queue[self.b:]
            # pad the wave to batch size by repeating the last request
            while len(wave) < self.b:
                wave.append(Request(-1, wave[-1].prompt, wave[-1].max_new))
            self.cache = self._empty_cache()
            max_prompt = max(len(r.prompt) for r in wave)
            prompts = np.stack([
                np.pad(r.prompt, (max_prompt - len(r.prompt), 0),
                       constant_values=0) for r in wave])
            prompts = torch.as_tensor(prompts, dtype=torch.long,
                                      device=self.device)
            tok = None
            for i in range(max_prompt):
                tok = self._decode(prompts[:, i:i + 1], i)
                steps += 1
            max_new = max(r.max_new for r in wave)
            for j in range(max_new):
                toks = tok[:, 0].tolist()
                for slot, r in enumerate(wave):
                    if r.rid >= 0 and j < r.max_new:
                        r.out.append(int(toks[slot]))
                tok = self._decode(tok, max_prompt + j)
                steps += 1
            done.extend(r for r in wave if r.rid >= 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        total_tokens = sum(len(r.out) for r in done)
        return {"requests": len(done), "tokens": total_tokens,
                "wall_s": dt, "tok_per_s": total_tokens / max(dt, 1e-9),
                "decode_steps": steps,
                "completions": {r.rid: r.out[:8] for r in done}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    rng = np.random.default_rng(args.seed)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                           device=dev)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        rng.integers(4, 24)).astype(np.int32),
                    max_new=args.gen)
            for i in range(args.requests)]
    server = BatchedServer(cfg, params, args.batch, cache_len=64 + args.gen,
                           device=dev)
    stats = server.run(reqs)
    print(f"served {stats['requests']} requests, {stats['tokens']} tokens "
          f"in {stats['wall_s']:.1f}s ({stats['tok_per_s']:.1f} tok/s, "
          f"reduced {cfg.name} on {dev})")
    return stats


if __name__ == "__main__":
    main()
