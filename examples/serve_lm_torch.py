"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode tokens greedily with the KV-cache serve path, reporting per-phase
token throughput.  The counterpart of ``examples/serve_lm.py``, with the
same flags plus ``--device`` (the card unless ``--device cpu``).  Every
architecture of the registry serves: the VLM's patch embeddings and the
encoder-decoder's frames are drawn from the seed, on the device.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2_1_5b --tokens 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --arch gemma3_12b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --arch rwkv6_7b
    PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-large-v3
"""

import argparse
import time

import torch

from repro_torch.configs import get_smoke
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.models import model as M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    B = args.batch
    max_len = args.prompt_len + args.tokens + (
        cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    caches = M.init_caches(cfg, B, max_len, dev)
    gen = torch.Generator(dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, args.prompt_len), generator=gen,
                                     device=dev)}
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=gen, device=dev).to(cfg.dtype)
    if cfg.enc_dec:
        batch["frames"] = torch.randn((B, args.prompt_len, cfg.d_model), generator=gen,
                                      device=dev).to(cfg.dtype)

    prefill = M.make_prefill_step(cfg, M.SHAPES["smoke_prefill"])
    serve = M.make_serve_step(cfg)

    t0 = time.time()
    logits, caches = prefill(params, batch, caches)
    synchronize(dev)
    t_prefill = time.time() - t0

    tok = logits[:, -1].argmax(-1)[:, None]
    out_tokens = [tok[:, 0]]
    t0 = time.time()
    for _ in range(args.tokens - 1):
        logits, caches = serve(params, {"token": tok}, caches)
        tok = logits[:, -1].argmax(-1)[:, None]
        out_tokens.append(tok[:, 0])
    synchronize(dev)
    t_decode = time.time() - t0

    gen = torch.stack(out_tokens, dim=1).cpu()
    print(f"arch={cfg.name} device={device_name(dev)} batch={B} prompt={args.prompt_len} "
          f"generated={gen.shape[1]} tokens/request")
    print(f"prefill: {t_prefill*1e3:.0f} ms ({B*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.0f} ms ({B*(args.tokens-1)/t_decode:.0f} tok/s)")
    print("sample token ids (request 0):", gen[0, :16].tolist())
    assert bool(torch.isfinite(logits.float()).all())


if __name__ == "__main__":
    main()
