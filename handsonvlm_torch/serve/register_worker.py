"""Manually (re)register a worker with the controller.

Port of `handsonvlm_tpu/serve/register_worker.py` (stdlib only).
Reference: llava/serve/register_worker.py — the operator escape hatch when
a worker missed its registration (e.g. the controller restarted).

Usage:
  python -m handsonvlm_torch.serve.register_worker \
      --controller-address http://localhost:10000 \
      --worker-name http://localhost:40000
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", required=True)
    p.add_argument("--worker-name", required=True)
    p.add_argument("--check-heart-beat", action="store_true", default=True)
    args = p.parse_args(argv)

    # pull the worker's live status so the registration carries real
    # model names / queue length (reference posts status-less; we can do
    # better since the worker exposes /worker_get_status)
    req = urllib.request.Request(
        args.worker_name + "/worker_get_status", b"{}",
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        status = json.loads(r.read())

    req = urllib.request.Request(
        args.controller_address + "/register_worker",
        json.dumps({
            "worker_name": args.worker_name,
            "check_heart_beat": args.check_heart_beat,
            "worker_status": status,
        }).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        reply = json.loads(r.read())
    print(reply)
    return reply


if __name__ == "__main__":
    main()
