"""Interactive index page for the port's tts-server.

The port's own copy of `tts_tpu/apps/web_ui.py`'s page: model picker with
refresh, voice picker, text box, sampling controls (temperature / top-k /
top-p / repetition penalty), synthesis via POST /v1/audio/speech, in-page
playback and the X-RTF / generation-time stats.
"""

INDEX_HTML = b"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>tts_tpu</title>
<style>
  :root {
    --bg: #10141a; --panel: #1a212b; --edge: #2c3847; --ink: #e8edf3;
    --dim: #8fa1b5; --accent: #4da3ff; --accent-ink: #0b1320;
  }
  * { box-sizing: border-box; }
  body {
    margin: 0; min-height: 100vh; display: grid; place-items: center;
    background: var(--bg); color: var(--ink);
    font: 15px/1.5 system-ui, -apple-system, "Segoe UI", sans-serif;
  }
  main { width: min(680px, 94vw); padding: 2rem 0 3rem; }
  h1 { font-size: 1.3rem; letter-spacing: .02em; margin: 0 0 .25rem; }
  h1 small { color: var(--dim); font-weight: 400; margin-left: .5rem; }
  .card {
    background: var(--panel); border: 1px solid var(--edge);
    border-radius: 10px; padding: 1.25rem; margin-top: 1rem;
  }
  label { display: block; color: var(--dim); font-size: .8rem;
          text-transform: uppercase; letter-spacing: .06em; margin: .9rem 0 .3rem; }
  textarea, select, input[type=number] {
    width: 100%; background: var(--bg); color: var(--ink);
    border: 1px solid var(--edge); border-radius: 6px; padding: .55rem .7rem;
    font: inherit;
  }
  textarea { min-height: 6.5rem; resize: vertical; }
  .row { display: flex; gap: .75rem; }
  .row > div { flex: 1; }
  .knobs { display: grid; grid-template-columns: 1fr 1fr; gap: 0 1.25rem; }
  .knob output { float: right; color: var(--ink); font-variant-numeric: tabular-nums; }
  input[type=range] { width: 100%; accent-color: var(--accent); }
  button {
    margin-top: 1.1rem; width: 100%; padding: .7rem; border: 0;
    border-radius: 6px; background: var(--accent); color: var(--accent-ink);
    font: inherit; font-weight: 600; cursor: pointer;
  }
  button:disabled { opacity: .5; cursor: wait; }
  button.ghost { background: transparent; color: var(--dim);
                 border: 1px solid var(--edge); width: auto; margin: 0;
                 padding: .45rem .8rem; }
  audio { width: 100%; margin-top: 1rem; display: none; }
  #stats { color: var(--dim); font-size: .85rem; margin-top: .6rem;
           font-variant-numeric: tabular-nums; }
  #error { color: #ff8f8f; margin-top: .6rem; white-space: pre-wrap; }
</style>
</head>
<body>
<main>
  <h1>tts_tpu<small>text to speech</small></h1>
  <div class="card">
    <div class="row" style="align-items:flex-end">
      <div>
        <label for="model">Model</label>
        <select id="model"></select>
      </div>
      <div style="flex:0">
        <button class="ghost" id="reload" title="Re-query models and voices">&#8635;</button>
      </div>
      <div>
        <label for="voice">Voice</label>
        <select id="voice"><option value="">(default)</option></select>
      </div>
    </div>

    <label for="text">Text</label>
    <textarea id="text" placeholder="Type something to speak&hellip;"></textarea>

    <div class="knobs">
      <div class="knob">
        <label for="temperature">Temperature <output id="temperature-v">1.00</output></label>
        <input type="range" id="temperature" min="0" max="2" step="0.01" value="1">
      </div>
      <div class="knob">
        <label for="top_k">Top-k <output id="top_k-v">off</output></label>
        <input type="range" id="top_k" min="0" max="200" step="1" value="0">
      </div>
      <div class="knob">
        <label for="top_p">Top-p <output id="top_p-v">off</output></label>
        <input type="range" id="top_p" min="0.01" max="1" step="0.01" value="1">
      </div>
      <div class="knob">
        <label for="repetition_penalty">Repetition penalty <output id="repetition_penalty-v">1.00</output></label>
        <input type="range" id="repetition_penalty" min="1" max="2" step="0.01" value="1">
      </div>
    </div>

    <button id="speak">Speak</button>
    <audio id="player" controls></audio>
    <div id="stats"></div>
    <div id="error"></div>
  </div>
</main>
<script>
const $ = id => document.getElementById(id);
const knobs = ["temperature", "top_k", "top_p", "repetition_penalty"];
for (const k of knobs) {
  const show = () => {
    const v = parseFloat($(k).value);
    $(k + "-v").textContent =
      (k === "top_k" && v === 0) || (k === "top_p" && v === 1)
        ? "off" : (k === "top_k" ? v.toFixed(0) : v.toFixed(2));
  };
  $(k).addEventListener("input", show);
  show();
}

async function loadModels() {
  $("error").textContent = "";
  try {
    const models = (await (await fetch("/v1/models")).json()).data ?? [];
    $("model").replaceChildren(...models.map(m => new Option(m.id, m.id)));
    const voices = await (await fetch("/v1/audio/voices")).json();
    updateVoices(voices);
    $("model").onchange = () => updateVoices(voices);
  } catch (e) { $("error").textContent = "failed to load models: " + e; }
}
function updateVoices(voices) {
  const v = voices[$("model").value] ?? [];
  $("voice").replaceChildren(new Option("(default)", ""),
                             ...v.map(x => new Option(x, x)));
}

$("reload").onclick = loadModels;
$("speak").onclick = async () => {
  const text = $("text").value.trim();
  if (!text) { $("error").textContent = "enter some text first"; return; }
  $("speak").disabled = true;
  $("error").textContent = "";
  $("stats").textContent = "generating\\u2026";
  const t0 = performance.now();
  try {
    const body = { input: text, model: $("model").value };
    if ($("voice").value) body.voice = $("voice").value;
    body.temperature = parseFloat($("temperature").value);
    body.top_k = parseInt($("top_k").value);
    body.top_p = parseFloat($("top_p").value);
    body.repetition_penalty = parseFloat($("repetition_penalty").value);
    const r = await fetch("/v1/audio/speech", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    if (!r.ok) {
      const err = await r.json().catch(() => null);
      throw new Error(err?.error?.message ?? r.status + " " + r.statusText);
    }
    const blob = await r.blob();
    const player = $("player");
    player.src = URL.createObjectURL(blob);
    player.style.display = "block";
    player.play();
    const wall = ((performance.now() - t0) / 1000).toFixed(2);
    const rtf = r.headers.get("X-RTF");
    const gen = r.headers.get("X-Generation-Time-Ms");
    $("stats").textContent = `round trip ${wall}s` +
      (gen ? ` \\u00b7 generation ${(gen / 1000).toFixed(2)}s` : "") +
      (rtf ? ` \\u00b7 RTF ${parseFloat(rtf).toFixed(4)}` : "");
  } catch (e) {
    $("stats").textContent = "";
    $("error").textContent = String(e.message ?? e);
  } finally {
    $("speak").disabled = false;
  }
};
loadModels();
</script>
</body>
</html>
"""
