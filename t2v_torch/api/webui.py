"""Single-file browser UI of the port — the stand-in for the reference's
Gradio "txt2video" tab (text2vid.py:45-88) plus its progress-polling JS
(javascript/t2v_progressbar.js): a generate form over POST /t2v/run, a
progress bar fed by GET /t2v/progress, Interrupt/Skip buttons, and inline
result videos from the returned data URLs. No external assets, no gradio —
served by both the FastAPI app and the stdlib fallback server. The port's
copy of the JAX package's ``api/webui.py``.
"""

from t2v_torch.core.config import SAMPLER_NAMES

_SAMPLER_OPTIONS = "".join(f"<option>{n}</option>" for n in SAMPLER_NAMES)

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>text2video (GPU)</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 880px;
         background: #111; color: #eee; }
  fieldset { border: 1px solid #444; border-radius: 8px; margin-bottom: 1rem; }
  label { display: inline-block; min-width: 9rem; margin: .25rem 0; }
  input, select, textarea { background: #222; color: #eee; border: 1px solid #555;
         border-radius: 4px; padding: .3rem; }
  textarea { width: 98%; }
  button { padding: .5rem 1.2rem; border-radius: 6px; border: none; cursor: pointer; }
  #generate { background: #c25f1e; color: white; font-weight: 600; }
  #interrupt, #skip { background: #333; color: #eee; }
  #bar { height: 10px; background: #c25f1e; width: 0%; border-radius: 5px;
         transition: width .3s; }
  #barbox { background: #222; border-radius: 5px; margin: 1rem 0; }
  video { max-width: 100%; margin-top: 1rem; border-radius: 8px; }
  .err { color: #f66; white-space: pre-wrap; }
</style>
</head>
<body>
<h2>text2video <small style="color:#888">PyTorch / CUDA</small></h2>
<fieldset><legend>Prompt</legend>
  <textarea id="prompt" rows="2">a horse galloping through a meadow</textarea>
  <textarea id="n_prompt" rows="1">text, watermark, copyright, blurry, nsfw</textarea>
</fieldset>
<fieldset><legend>Settings</legend>
  <label>Model type</label><select id="model"><option value="&lt;modelscope&gt;">ModelScope</option><option value="&lt;videocrafter&gt;">VideoCrafter</option></select><br>
  <label>Sampler</label><select id="sampler">__SAMPLER_OPTIONS__</select><br>
  <label>Steps</label><input id="steps" type="number" value="30"><br>
  <label>Frames</label><input id="frames" type="number" value="24"><br>
  <label>Width</label><input id="width" type="number" value="256" step="64">
  <label>Height</label><input id="height" type="number" value="256" step="64"><br>
  <label>CFG scale</label><input id="cfg_scale" type="number" value="17"><br>
  <label>Seed</label><input id="seed" type="number" value="-1"><br>
  <label>Batch count</label><input id="batch_count" type="number" value="1"><br>
  <label>FPS</label><input id="fps" type="number" value="15"><br>
</fieldset>
<button id="generate">Generate</button>
<button id="interrupt">Interrupt</button>
<button id="skip">Skip</button>
<div id="barbox"><div id="bar"></div></div>
<div id="status"></div>
<div id="out"></div>
<details><summary>Metadata viewer</summary>
  <input id="meta_file" type="file" accept="video/mp4">
  <button id="meta_btn">Get metadata</button>
  <pre id="meta_out"></pre>
</details>
<script>
const $ = id => document.getElementById(id);
let polling = null;
function poll() {
  fetch('/t2v/progress').then(r => r.json()).then(p => {
    const pct = p.sampling_steps ? Math.round(100 * p.sampling_step / p.sampling_steps) : 0;
    $('bar').style.width = pct + '%';
    $('status').textContent = p.job_count > 1
      ? `batch ${p.job_no + 1}/${p.job_count} — step ${p.sampling_step}/${p.sampling_steps}`
      : `step ${p.sampling_step}/${p.sampling_steps}`;
  }).catch(() => {});
}
$('generate').onclick = async () => {
  $('out').innerHTML = ''; $('status').textContent = 'running…';
  polling = setInterval(poll, 1000);
  const q = new URLSearchParams();
  for (const k of ['prompt','n_prompt','model','sampler','steps','frames',
                   'width','height','cfg_scale','seed','batch_count','fps'])
    q.set(k, $(k).value);
  q.set('model_type',
        $('model').value.includes('videocrafter') ? 'VideoCrafter' : 'ModelScope');
  try {
    const r = await fetch('/t2v/run?' + q.toString(), {method: 'POST'});
    const j = await r.json();
    if (j.mp4s) {
      for (const url of j.mp4s) {
        const v = document.createElement('video');
        v.src = url; v.controls = true; v.loop = true; v.autoplay = true;
        $('out').appendChild(v);
      }
      $('status').textContent = 'done';
    } else {
      $('status').innerHTML = '<span class="err">' + JSON.stringify(j) + '</span>';
    }
  } catch (e) {
    $('status').innerHTML = '<span class="err">' + e + '</span>';
  } finally {
    clearInterval(polling); $('bar').style.width = '0%';
  }
};
$('interrupt').onclick = () => fetch('/t2v/interrupt', {method: 'POST'});
$('skip').onclick = () => fetch('/t2v/skip', {method: 'POST'});
$('meta_btn').onclick = async () => {
  const f = $('meta_file').files[0];
  if (!f) { $('meta_out').textContent = 'choose an .mp4 first'; return; }
  const fd = new FormData(); fd.append('file', f);
  const r = await fetch('/t2v/metadata', {method: 'POST', body: fd});
  const j = await r.json();
  $('meta_out').textContent = j.comment || '(no ©cmt metadata atom)';
};
</script>
</body>
</html>
""".replace("__SAMPLER_OPTIONS__", _SAMPLER_OPTIONS)
