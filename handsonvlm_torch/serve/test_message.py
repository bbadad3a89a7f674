"""Smoke client: ask the controller for a worker and send one generate.

Port of `handsonvlm_tpu/serve/test_message.py` (stdlib only).
Reference: llava/serve/test_message.py.

Usage:
  python -m handsonvlm_torch.serve.test_message --controller http://localhost:10000 \
      --model handsonvlm-7b --message "Where should my hand move to open the fridge?"
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def _post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller", default="http://localhost:10000")
    p.add_argument("--worker", default=None, help="bypass controller dispatch")
    p.add_argument("--model", default=None)
    p.add_argument("--message", default="Can you provide the hand trajectory?")
    p.add_argument("--max-new-tokens", type=int, default=32)
    args = p.parse_args(argv)

    worker = args.worker
    if worker is None:
        models = _post(args.controller + "/list_models", {})["models"]
        print("models:", models)
        model = args.model or models[0]
        worker = _post(args.controller + "/get_worker_address", {"model": model})["address"]
        print("worker:", worker)
    out = _post(
        worker + "/worker_generate",
        {"prompt": args.message, "max_new_tokens": args.max_new_tokens},
    )
    print(json.dumps({k: v for k, v in out.items() if k != "pred_hands"}, indent=2))
    if out.get("trajectory_valid"):
        print("pred_hands:", out["pred_hands"])
    return out


if __name__ == "__main__":
    main()
