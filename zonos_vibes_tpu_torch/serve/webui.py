"""Web UI (a copy of the JAX package's ``serve/webui.py`` page): a dependency-free page
with the reference Gradio app's control surface (text, language, model,
speaker and prefix audio as base64 WAV uploads or server paths, the 8
emotion sliders, vq_single, fmax, pitch_std, speaking_rate, dnsmos, speaker
noised, CFG scale, seed, the unified sampler and top-p/top-k/min-p, the
unconditional keys), a progress estimate from the live ``/metrics`` RTF.
It POSTs JSON to ``/tts`` and plays the WAV.
"""

from __future__ import annotations

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>zonos-tpu</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 760px; }
  fieldset { margin-bottom: 1rem; border: 1px solid #ccc; border-radius: 6px; }
  label { display: inline-block; min-width: 11rem; margin: 0.15rem 0; }
  input[type=range] { width: 14rem; vertical-align: middle; }
  .val { display: inline-block; width: 3.5rem; text-align: right; }
  textarea { width: 100%; }
  #status { color: #666; margin-left: 1rem; }
</style>
</head>
<body>
<h2>zonos-tpu TTS</h2>
<fieldset><legend>Text</legend>
  <textarea id="text" rows="3" maxlength="500">Zonos uses eSpeak for text to phoneme conversion, and a DAC autoencoder.</textarea>
  <label>Language <select id="language"></select></label>
  <label>Model <select id="model"><option value="default" selected>default</option></select></label>
  <label>Speaker wav <input type="file" id="speaker_file" accept=".wav,audio/wav"></label>
  <label>&nbsp;&nbsp;or server path <input id="speaker" size="32" placeholder="/path/to/speaker.wav"></input></label>
  <label>Prefix audio <input type="file" id="prefix_file" accept=".wav,audio/wav"></label>
  <label>&nbsp;&nbsp;or server path <input id="prefix" size="32" placeholder="/path/to/prefix.wav (continuation)"></input></label>
</fieldset>
<fieldset><legend>Conditioning</legend>
  <div id="sliders"></div>
  <label>Speaker noised <input type="checkbox" id="speaker_noised"></label>
</fieldset>
<fieldset><legend>Emotion <label><input type="checkbox" id="uncond_emotion" checked> unconditional</label></legend>
  <div id="emotions"></div>
</fieldset>
<fieldset><legend>Sampling</legend>
  <div id="sampling"></div>
  <label>Seed <input id="seed" type="number" value="420" style="width:7rem">
  <button type="button" onclick="document.getElementById('seed').value=Math.floor(Math.random()*1e6)">randomize</button></label>
</fieldset>
<button id="go" onclick="generate()">Generate</button><span id="status"></span>
<div><audio id="player" controls style="margin-top:1rem;width:100%"></audio></div>
<script>
const LANGS = __LANGS__;
const EMOTIONS = ["Happiness","Sadness","Disgust","Fear","Surprise","Anger","Other","Neutral"];
const EMO_DEFAULT = [0.3077,0.0256,0.0256,0.0256,0.0256,0.0256,0.2564,0.3077];
const SLIDERS = [
  ["fmax", 0, 24000, 22050, 50],
  ["pitch_std", 0, 400, 20, 1],
  ["speaking_rate", 0, 40, 15, 0.5],
  ["dnsmos_ovrl", 1, 5, 4, 0.1],
  ["vq_single", 0.5, 0.8, 0.78, 0.01],
  ["cfg_scale", 1.01, 5, 2, 0.05],
];
const SAMPLING = [
  ["linear", 0, 1, 0.5, 0.01],
  ["conf", -2, 2, 0.4, 0.01],
  ["quad", -2, 2, 0, 0.01],
  ["top_p", 0, 1, 0, 0.01],
  ["top_k", 0, 1024, 0, 1],
  ["min_p", 0, 0.5, 0, 0.01],
  ["max_seconds", 1, 30, 10, 1],
];
function slider(parent, name, lo, hi, v, step) {
  const d = document.createElement("div");
  d.innerHTML = `<label>${name}</label><input type="range" id="${name}" min="${lo}" max="${hi}" value="${v}" step="${step}"
    oninput="document.getElementById('${name}_v').textContent=this.value"><span class="val" id="${name}_v">${v}</span>`;
  parent.appendChild(d);
}
const sel = document.getElementById("language");
LANGS.forEach(l => { const o = document.createElement("option"); o.value = o.text = l; if (l==="en-us") o.selected = true; sel.add(o); });
SLIDERS.forEach(s => slider(document.getElementById("sliders"), ...s));
// Dynamic show/hide by the loaded model's conditioners (the reference's
// update_ui, gradio_interface.py:31-82): hybrid-only knobs disappear when
// the transformer checkpoint is loaded.
const KNOB_TO_COND = {fmax: "fmax", pitch_std: "pitch_std",
                      speaking_rate: "speaking_rate", dnsmos_ovrl: "dnsmos_ovrl",
                      vq_single: "vqscore_8"};
let activeConds = null;  // conditioner roster of the SELECTED model
fetch("/model-info").then(r => r.json()).then(info => {
  // Model selector (reference dropdown, gradio_interface.py:206-217).
  const msel = document.getElementById("model");
  msel.innerHTML = "";
  (info.models || ["default"]).forEach(m => {
    const o = document.createElement("option");
    o.value = o.text = m; if (m === "default") o.selected = true; msel.add(o);
  });
  const byModel = info.conditioners_by_model || {"default": info.conditioners};
  msel.onchange = () => {
    activeConds = new Set(byModel[msel.value] || []);
    applyVisibility(activeConds);
  };
  activeConds = new Set(info.conditioners);
  applyVisibility(activeConds);
}).catch(() => {});
function applyVisibility(have) {
  for (const [knob, cond] of Object.entries(KNOB_TO_COND)) {
    const el = document.getElementById(knob);
    if (el) el.parentElement.style.display = have.has(cond) ? "" : "none";
  }
  document.getElementById("speaker_noised").parentElement.style.display =
    have.has("speaker_noised") ? "" : "none";
  document.getElementById("emotions").parentElement.style.display =
    have.has("emotion") ? "" : "none";
}
SAMPLING.forEach(s => slider(document.getElementById("sampling"), ...s));
EMOTIONS.forEach((e, i) => slider(document.getElementById("emotions"), "emo_" + e, 0, 1, EMO_DEFAULT[i], 0.01));
const val = id => parseFloat(document.getElementById(id).value);
// Uploaded audio travels inline as base64 WAV (reference Gradio UI accepts
// uploads, gradio_interface.py:240-244); server paths remain supported.
function fileB64(id) {
  const f = document.getElementById(id).files[0];
  if (!f) return Promise.resolve(null);
  return new Promise((res, rej) => {
    const r = new FileReader();
    r.onload = () => res(r.result.split(",")[1]);
    r.onerror = rej;
    r.readAsDataURL(f);
  });
}
// Progress estimate (reference gradio_interface.py:182-187): expected wall
// time from the live /metrics RTF and the requested audio length.
let progressTimer = null;
function startProgress(status, expectedSeconds) {
  const t0 = Date.now();
  progressTimer = setInterval(() => {
    const frac = Math.min(0.99, (Date.now() - t0) / 1000 / expectedSeconds);
    status.textContent = `generating... ${Math.round(frac * 100)}% (est ${expectedSeconds.toFixed(0)}s)`;
  }, 250);
}
function stopProgress() { if (progressTimer) { clearInterval(progressTimer); progressTimer = null; } }
async function generate() {
  const status = document.getElementById("status");
  status.textContent = "generating...";
  document.getElementById("go").disabled = true;
  const uncond = [];
  if (document.getElementById("uncond_emotion").checked) uncond.push("emotion");
  uncond.push("vqscore_8", "dnsmos_ovrl");
  let rtf = 1.0;
  try {
    const m = await (await fetch("/metrics")).json();
    if (m.rtf > 0.05) rtf = m.rtf;
  } catch (e) {}
  startProgress(status, val("max_seconds") / rtf + 1);
  const payload = {
    ui: true,  // speaker-less allowance marker (server._parse)
    model: document.getElementById("model").value,
    text: document.getElementById("text").value,
    language: document.getElementById("language").value,
    speaker_audio_path: document.getElementById("speaker").value || null,
    prefix_audio_path: document.getElementById("prefix").value || null,
    speaker_audio: await fileB64("speaker_file"),
    prefix_audio: await fileB64("prefix_file"),
    cfg_scale: val("cfg_scale"), seed: val("seed"),
    sampling: { linear: val("linear"), conf: val("conf"), quad: val("quad"),
                top_p: val("top_p"), top_k: val("top_k"), min_p: val("min_p") },
    max_new_tokens: Math.round(86 * val("max_seconds")),
    unconditional_keys: uncond,
  };
  // Knobs ride the payload only when the SELECTED model has the matching
  // conditioner (reference update_ui: hidden controls don't contribute,
  // gradio_interface.py:31-82,166-179).
  const has = c => !activeConds || activeConds.has(c);
  if (has("emotion")) payload.emotion = EMOTIONS.map(e => val("emo_" + e));
  if (has("vqscore_8")) payload.vqscore_8 = Array(8).fill(val("vq_single"));
  if (has("fmax")) payload.fmax = val("fmax");
  if (has("pitch_std")) payload.pitch_std = val("pitch_std");
  if (has("speaking_rate")) payload.speaking_rate = val("speaking_rate");
  if (has("dnsmos_ovrl")) payload.dnsmos_ovrl = val("dnsmos_ovrl");
  if (has("speaker_noised"))
    payload.speaker_noised = document.getElementById("speaker_noised").checked;
  try {
    const r = await fetch("/tts", {method: "POST", headers: {"Content-Type": "application/json"},
                                   body: JSON.stringify(payload)});
    stopProgress();
    if (!r.ok) { status.textContent = "error: " + (await r.text()).slice(0, 200); return; }
    const blob = await r.blob();
    document.getElementById("player").src = URL.createObjectURL(blob);
    document.getElementById("player").play();
    status.textContent = "done";
  } catch (e) { stopProgress(); status.textContent = "error: " + e; }
  finally { stopProgress(); document.getElementById("go").disabled = false; }
}
</script>
</body>
</html>
"""


def index_html() -> bytes:
    import json

    from ..pipeline import supported_language_codes

    return INDEX_HTML.replace(
        "__LANGS__", json.dumps(supported_language_codes)
    ).encode()
