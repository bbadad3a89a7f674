"""Web chat UI: browser frontend over the controller/worker stack.

Port of `handsonvlm_tpu/serve/web_server.py` (its own copy: stdlib only).
Replaces `llava/serve/gradio_web_server.py` (419 LoC of gradio plumbing)
with a single-page stdlib app covering the reference's feature set:
image upload + prompt + sampling knobs, MULTI-TURN conversation state
(history rides each /generate request and is rendered into the v1 conv
template by the worker), regenerate/clear, streamed token display (chunked
transfer pass-through from the worker's /worker_generate_stream), up/down/
flag vote logging and per-request conversation logs ({date}-conv.json,
gradio_web_server.py vote_last_response/get_conv_log_filename), and a
client-side canvas overlay of the predicted hand trajectory — the browser
analogue of the reference's trajectory-video render
(handsonvlm/evaluation/utils.py:create_trajectory_video).

Endpoints:
  GET  /            -> HTML page
  POST /list_models -> proxied controller /list_models
  POST /generate    -> resolves a worker via the controller, re-streams its
                       \0-delimited JSON chunks to the browser, logs the
                       finished conversation
  POST /vote        -> append a vote record to the daily conv log

Usage:
  python -m handsonvlm_torch.serve.web_server --controller http://localhost:10000
"""

from __future__ import annotations

import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>HandsOnVLM</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:900px;margin:24px auto;padding:0 12px}
 textarea,input,select,button{font:inherit;padding:6px;margin:4px 0}
 #out{white-space:pre-wrap;border:1px solid #ccc;border-radius:6px;padding:10px;min-height:3em}
 #wrap{position:relative;display:inline-block}
 #overlay{position:absolute;left:0;top:0;pointer-events:none}
 .row{display:flex;gap:12px;align-items:center;flex-wrap:wrap}
 label{font-size:.9em;color:#444}
 #chat{margin:8px 0}
 .turn{padding:6px 10px;margin:3px 0;border-radius:8px;white-space:pre-wrap}
 .turn.user{background:#eef}
 .turn.asst{background:#efe}
</style></head><body>
<h2>HandsOnVLM &mdash; hand trajectory chat</h2>
<div class="row">
 <label>Model <select id="model"></select></label>
 <label>Temperature <input id="temp" type="number" step="0.1" value="0.5" style="width:5em"></label>
 <label>Top-p <input id="topp" type="number" step="0.05" value="0.9" style="width:5em"></label>
 <label>Max tokens <input id="maxtok" type="number" value="100" style="width:5em"></label>
</div>
<div class="row">
 <input id="img" type="file" accept="image/*">
 <div id="wrap"><img id="preview" style="max-width:456px;display:none">
  <canvas id="overlay"></canvas></div>
</div>
<div id="chat"></div>
<textarea id="prompt" rows="2" style="width:100%"
 placeholder="Where should my hand move to reach for the cup?"></textarea>
<div class="row">
 <button id="go">Send</button>
 <button id="regen">Regenerate</button>
 <button id="clear">Clear history</button>
 <button id="up">&#128077;</button>
 <button id="down">&#128078;</button>
 <button id="flag">&#9873;</button>
</div>
<h3>Response</h3><div id="out"></div>
<script>
const $ = id => document.getElementById(id);
let imgB64 = null;
let history = [];  // [[user, assistant], ...] — multi-turn state
let lastPrompt = null;
function renderChat(){
  const c=$('chat'); c.innerHTML='';
  for (const [u,a] of history){
    const du=document.createElement('div'); du.className='turn user'; du.textContent='USER: '+u;
    const da=document.createElement('div'); da.className='turn asst'; da.textContent='ASSISTANT: '+a;
    c.append(du, da);
  }
}
function vote(kind){
  fetch('/vote', {method:'POST', body: JSON.stringify({type:kind,
    model: $('model').value, history: history, state: lastPrompt})});
}
$('up').onclick=()=>vote('upvote'); $('down').onclick=()=>vote('downvote');
$('flag').onclick=()=>vote('flag');
$('clear').onclick=()=>{history=[]; renderChat(); $('out').textContent='';};
$('regen').onclick=()=>{ if(history.length){const popped=history.pop(); renderChat(); send(popped[0], popped);} };
fetch('/list_models', {method:'POST'}).then(r=>r.json()).then(d=>{
  for (const m of d.models) { const o=document.createElement('option'); o.textContent=m; $('model').append(o); }
});
$('img').onchange = () => {
  const f = $('img').files[0]; if (!f) return;
  const rd = new FileReader();
  rd.onload = () => {
    imgB64 = rd.result.split(',')[1];
    $('preview').src = rd.result; $('preview').style.display='block';
    $('preview').onload = () => {
      const c=$('overlay'); c.width=$('preview').width; c.height=$('preview').height;
      c.getContext('2d').clearRect(0,0,c.width,c.height);
    };
  };
  rd.readAsDataURL(f);
};
function drawTraj(pred) {
  // pred: (1,2,4,2) normalized [0,1] coords; gradient polyline per hand
  const c=$('overlay'), ctx=c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  const colors=[[255,64,64],[64,128,255]];
  pred[0].forEach((hand,h)=>{
    ctx.lineWidth=3;
    for (let i=1;i<hand.length;i++){
      const a=1 - 0.8*(hand.length-1-i)/hand.length;
      ctx.strokeStyle=`rgba(${colors[h]},${a})`;
      ctx.beginPath();
      ctx.moveTo(hand[i-1][0]*c.width, hand[i-1][1]*c.height);
      ctx.lineTo(hand[i][0]*c.width, hand[i][1]*c.height);
      ctx.stroke();
    }
    hand.forEach(p=>{ctx.fillStyle=`rgb(${colors[h]})`;
      ctx.beginPath();ctx.arc(p[0]*c.width,p[1]*c.height,4,0,7);ctx.fill();});
  });
}
async function send(promptText, restoreOnFail){
  $('out').textContent='';
  for(const id of ['go','regen','clear']){const el=$(id); if(el) el.disabled=true;}
  lastPrompt = promptText;
  let finalText = '';
  let failed = false;
  try {
    const resp = await fetch('/generate', {method:'POST', body: JSON.stringify({
      model: $('model').value, prompt: promptText, image_b64: imgB64,
      history: history,
      temperature: +$('temp').value, top_p: +$('topp').value,
      max_new_tokens: +$('maxtok').value})});
    const reader = resp.body.getReader(); const dec = new TextDecoder();
    let buf='';
    for(;;){
      const {done, value} = await reader.read(); if (done) break;
      buf += dec.decode(value, {stream:true});
      const parts = buf.split('\\0'); buf = parts.pop();
      for (const p of parts) { if (!p) continue;
        const d = JSON.parse(p);
        if (d.error_code) { failed = true; $('out').textContent = 'error: ' + d.error; continue; }
        finalText = d.text; $('out').textContent = d.text;
        if (d.pred_hands && d.trajectory_valid) drawTraj(d.pred_hands);
      }
    }
    if (finalText && !failed) { history.push([promptText, finalText]); renderChat(); }
  } catch (e) {
    failed = true; $('out').textContent = 'error: ' + e;
  } finally {
    // regenerate popped the last turn before sending; if the retry failed
    // (worker error — even after partial streamed text — empty text, or a
    // fetch exception) restore it so a complete saved answer is never
    // silently replaced by a truncated one
    if ((failed || !finalText) && restoreOnFail) { history.push(restoreOnFail); renderChat(); }
    for(const id of ['go','regen','clear']){const el=$(id); if(el) el.disabled=false;}
  }
}
$('go').onclick = () => send($('prompt').value);
</script></body></html>
"""


def _post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


MODERATION_MSG = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."
)


def violates_moderation(text: str) -> bool:
    """OpenAI moderation check (reference llava/utils.py:102-123;
    gradio_web_server gates prompts on it when --moderate is set). Requires
    OPENAI_API_KEY; fails open on any error, like the reference."""
    import os

    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        return False
    try:
        req = urllib.request.Request(
            "https://api.openai.com/v1/moderations",
            json.dumps({"input": text.replace("\n", "")}).encode(),
            {"Content-Type": "application/json", "Authorization": "Bearer " + key},
        )
        with urllib.request.urlopen(req, timeout=5) as r:
            return bool(json.loads(r.read())["results"][0]["flagged"])
    except Exception:  # noqa: BLE001 — reference returns False on errors
        return False


def _conv_log_path(logdir: str) -> str:
    """Daily conversation log (reference get_conv_log_filename:
    {date}-conv.json, one JSON record per line)."""
    import datetime
    import os

    name = datetime.datetime.now().strftime("%Y-%m-%d") + "-conv.json"
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, name)


def _append_log(logdir: str, record: dict) -> None:
    import time as _time

    record = dict(record, tstamp=round(_time.time(), 4))
    record.pop("image_b64", None)  # don't persist raw image payloads
    try:
        with open(_conv_log_path(logdir), "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass


def serve_web(controller_addr: str, host: str = "0.0.0.0", port: int = 7860,
              moderate: bool = False, logdir: str = "logs"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, PAGE.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b'{"error": "unknown path"}')

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/list_models":
                try:
                    models = _post_json(controller_addr + "/list_models", {})
                except OSError as e:
                    self._send(502, json.dumps({"error": str(e), "models": []}).encode())
                    return
                self._send(200, json.dumps(models).encode())
            elif self.path == "/generate":
                self._proxy_generate(data)
            elif self.path == "/vote":
                # gradio_web_server vote_last_response equivalent
                _append_log(logdir, {
                    "type": data.get("type", "vote"),
                    "model": data.get("model"),
                    "history": data.get("history"),
                    "state": data.get("state"),
                })
                self._send(200, b'{"ok": true}')
            else:
                self._send(404, b'{"error": "unknown path"}')

        def _proxy_generate(self, data: dict):
            if moderate and violates_moderation(data.get("prompt", "")):
                self._send(400, json.dumps({"error": MODERATION_MSG}).encode())
                return
            upstream = None
            # a stale registry entry (crashed/re-registered worker) shows up
            # as an unreachable address: report it to the controller
            # (/remove_worker, mirroring the reference's removal on failed
            # refresh) and retry with a fresh pick instead of failing the
            # request on a ghost
            for attempt in (0, 1):
                try:
                    addr = _post_json(
                        controller_addr + "/get_worker_address", {"model": data.get("model", "")}
                    )["address"]
                except OSError as e:
                    self._send(502, json.dumps({"error": f"controller unreachable: {e}"}).encode())
                    return
                if not addr:
                    self._send(503, json.dumps(
                        {"error": f"no worker serves model {data.get('model')!r}"}
                    ).encode())
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate_stream", json.dumps(data).encode(),
                    {"Content-Type": "application/json"},
                )
                try:
                    upstream = urllib.request.urlopen(req, timeout=600)
                    break
                except OSError as e:
                    try:
                        _post_json(controller_addr + "/remove_worker",
                                   {"worker_name": addr})
                    except OSError:
                        pass
                    if attempt == 1:
                        self._send(502, json.dumps(
                            {"error": f"worker unreachable: {e}"}).encode())
                        return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            tail, done = b"", False
            try:
                while True:
                    # read1: at most one upstream chunk — read(n) would loop
                    # to fill n bytes, buffering the whole stream into one burst
                    chunk = upstream.read1(4096)
                    if not chunk:
                        break
                    # keep the last TWO \0-delimited parts (never truncate a
                    # part mid-JSON: a final chunk >8 KB used to get cut and
                    # log text=None for a successful generation)
                    tail += chunk
                    parts = tail.split(b"\0")
                    if len(parts) > 2:
                        tail = b"\0".join(parts[-2:])
                    self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    self.wfile.flush()
                done = True
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                upstream.close()
            # log the finished conversation (reference logs per finished
            # http_bot round) before the stream's last chunk, so a client
            # that has read the whole answer finds it logged; the final
            # worker chunk carries the full text
            final = {}
            for part in tail.split(b"\0"):
                if part.strip():
                    try:
                        final = json.loads(part)
                    except json.JSONDecodeError:
                        pass
            _append_log(logdir, {
                "type": "chat",
                "model": data.get("model"),
                "prompt": data.get("prompt"),
                "history": data.get("history"),
                "text": final.get("text"),
                "trajectory_valid": final.get("trajectory_valid"),
            })
            if done:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--controller", default="http://localhost:10000")
    p.add_argument("--moderate", action="store_true",
                   help="OpenAI moderation gate on prompts (needs OPENAI_API_KEY)")
    p.add_argument("--logdir", default="logs",
                   help="vote + conversation logs ({date}-conv.json)")
    args = p.parse_args(argv)
    server = serve_web(args.controller, args.host, args.port,
                       moderate=args.moderate, logdir=args.logdir)
    print(f"web UI on http://{args.host}:{args.port} (controller {args.controller})")
    server.serve_forever()


if __name__ == "__main__":
    main()
