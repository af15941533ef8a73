"""Self-hosted playground dashboard (layer 7).

The reference ships a SvelteKit control plane on Cloudflare (Pages + D1 +
KV + R2) with an interactive algorithm playground, pipeline inspector,
search and records UI (web/, SURVEY.md section 2.3). This build serves
the same capabilities as a single self-hosted page straight from the
service — no build system, no external services; auth/keys/usage already
live in the core server. The page drives the public JSON API:
  /v1/algorithms -> algorithm picker + tunables
  /v1/ingest/*   -> fingerprinting
  /v1/pipeline/inspect/* -> stage visualizations (MinHash slot heatmap,
                            SimHash bits, image stage thumbnails, audio
                            envelope + peak constellation)
  /v1/query      -> search

Copied from ucfp_tpu/server/webui.py; only its imports differ.
"""

PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ucfp-tpu playground</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#0e1117;color:#e6edf3}
 header{padding:12px 20px;background:#161b22;display:flex;gap:16px;align-items:center}
 h1{font-size:16px;margin:0}
 main{max-width:1060px;margin:0 auto;padding:20px}
 .tabs{display:flex;gap:8px;margin-bottom:16px}
 .tabs button{background:#21262d;color:#e6edf3;border:1px solid #30363d;
   padding:6px 14px;border-radius:6px;cursor:pointer}
 .tabs button.active{background:#1f6feb;border-color:#1f6feb}
 textarea,input,select{background:#0d1117;color:#e6edf3;border:1px solid #30363d;
   border-radius:6px;padding:6px;font-family:ui-monospace,monospace}
 textarea{width:100%;min-height:90px}
 .row{display:flex;gap:10px;flex-wrap:wrap;margin:8px 0;align-items:center}
 .card{background:#161b22;border:1px solid #30363d;border-radius:8px;
   padding:14px;margin-bottom:14px}
 .hex{font-family:ui-monospace,monospace;font-size:11px;word-break:break-all;
   max-height:120px;overflow:auto;background:#0d1117;padding:8px;border-radius:6px}
 canvas{background:#0d1117;border-radius:6px}
 button.go{background:#238636;color:#fff;border:0;padding:8px 18px;
   border-radius:6px;cursor:pointer;font-weight:600}
 label{font-size:12px;color:#8b949e}
 .kv{font-size:12px;color:#8b949e} .kv b{color:#e6edf3}
 img.stage{image-rendering:pixelated;border-radius:4px;border:1px solid #30363d}
</style>
</head>
<body>
<header>
 <h1>ucfp-tpu playground</h1>
 <a href="/docs" style="color:#58a6ff;text-decoration:none;font-size:13px">docs</a>
 <label>API token <input id="token" size="18" placeholder="bearer token"></label>
 <label>tenant <input id="tenant" size="4" value="0"></label>
 <span class="kv" id="info"></span>
 <span style="flex:1"></span>
 <label>email <input id="acct-email" size="16" placeholder="you@example.com"></label>
 <label>password <input id="acct-pw" type="password" size="10"></label>
 <button class="go" onclick="acct('signup')">Sign up</button>
 <button class="go" onclick="acct('login')">Log in</button>
 <button class="go" style="background:#6e7681" onclick="acct('logout')">Log out</button>
 <span class="kv" id="acct-state"></span>
</header>
<main>
 <div class="tabs">
  <button data-tab="text" class="active">Text</button>
  <button data-tab="image">Image</button>
  <button data-tab="audio">Audio</button>
  <button data-tab="search">Search</button>
  <button data-tab="records">Records</button>
  <button data-tab="bulk">Bulk</button>
  <button data-tab="usage">Usage</button>
  <button data-tab="keys">Keys</button>
 </div>

 <section id="tab-text" class="card">
  <div class="row">
   <label>algorithm <select id="text-algo"></select></label>
   <button class="go" onclick="runText()">Fingerprint</button>
  </div>
  <div class="row" id="text-tunables"></div>
  <textarea id="text-input">the quick brown fox jumps over the lazy dog</textarea>
  <label>compare against (optional — renders slot agreement + bit diff)</label>
  <textarea id="text-compare" style="min-height:48px" placeholder="second input for side-by-side diff"></textarea>
  <div id="text-out"></div>
 </section>

 <section id="tab-image" class="card" style="display:none">
  <div class="row">
   <label>algorithm <select id="img-algo"></select></label>
   <input type="file" id="img-file" accept="image/*">
   <label>compare <input type="file" id="img-compare" accept="image/*"></label>
   <button class="go" onclick="runImage()">Fingerprint</button>
  </div>
  <div class="row" id="img-tunables"></div>
  <div id="img-out"></div>
 </section>

 <section id="tab-audio" class="card" style="display:none">
  <div class="row">
   <label>algorithm <select id="aud-algo"></select></label>
   <input type="file" id="aud-file" accept="audio/*">
   <label>watermark key <input id="aud-wmkey" type="password" size="10"
     placeholder="per-tenant secret"></label>
   <button class="go" onclick="runAudio()">Fingerprint</button>
   <span class="kv">decoded to mono f32 in-browser (WebAudio), like the
   reference demo</span>
  </div>
  <div class="row" id="aud-tunables"></div>
  <div id="aud-out"></div>
 </section>

 <section id="tab-search" class="card" style="display:none">
  <div class="row">
   <label>terms <input id="q-terms" size="24" placeholder="keyword search"></label>
   <label>vector <input id="q-vector" size="24" placeholder="0.1, -0.3, … (hybrid when both)"></label>
   <label>k <input id="q-k" size="3" value="10"></label>
   <label>filter algorithm <input id="q-filter-algo" size="16" placeholder="e.g. minhash-h128"></label>
   <label><input type="checkbox" id="q-explain" checked> explain</label>
   <button class="go" onclick="runQuery()">Search</button>
  </div>
  <div id="q-out"></div>
 </section>

 <section id="tab-records" class="card" style="display:none">
  <div class="row">
   <label>record id <input id="r-id" size="10"></label>
   <button class="go" onclick="describeRec()">Describe</button>
   <button class="go" style="background:#da3633" onclick="deleteRec()">Delete</button>
   <button class="go" onclick="listRecs(0)">List</button>
  </div>
  <div id="r-out"></div>
 </section>

 <section id="tab-bulk" class="card" style="display:none">
  <div class="row">
   <label>algorithm <select id="bulk-algo">
    <option value="minhash">minhash</option><option value="simhash-tf">simhash-tf</option>
    <option value="tlsh">tlsh</option></select></label>
   <label>start record id <input id="bulk-start" size="8" value="1000"></label>
   <button class="go" onclick="runBulk()">Ingest lines</button>
   <span class="kv">one text record per line (the dashboard bulk page)</span>
  </div>
  <textarea id="bulk-input" placeholder="one document per line"></textarea>
  <div id="bulk-out"></div>
 </section>

 <section id="tab-usage" class="card" style="display:none">
  <div class="row">
   <label>limit <input id="u-limit" size="5" value="200"></label>
   <button class="go" onclick="loadUsage()">Refresh</button>
   <span class="kv">tenant-scoped unless service bearer</span>
  </div>
  <div id="u-out"></div>
 </section>

 <section id="tab-keys" class="card" style="display:none">
  <div class="row">
   <label>tenant <input id="k-tenant" size="4" value="1"></label>
   <label>key id <input id="k-id" size="12" placeholder="optional"></label>
   <button class="go" onclick="createKey()">Issue key</button>
   <button class="go" onclick="listKeys()">List</button>
   <span class="kv">service bearer required</span>
  </div>
  <div id="k-out"></div>
 </section>
</main>
<script>
const $=id=>document.getElementById(id);
const tok=()=>$('token').value.trim();
const ten=()=>parseInt($('tenant').value)||0;
let RID=1;
document.querySelectorAll('.tabs button').forEach(b=>b.onclick=()=>{
 document.querySelectorAll('.tabs button').forEach(x=>x.classList.remove('active'));
 b.classList.add('active');
 ['text','image','audio','search','records','bulk','usage','keys'].forEach(t=>
   $('tab-'+t).style.display = t===b.dataset.tab?'':'none');
});
$('token').value = localStorage.getItem('ucfp_token')||'';
$('token').onchange=()=>localStorage.setItem('ucfp_token',tok());

async function api(path, opts={}){
 // bearer wins when pasted; otherwise the ucfp_session cookie (set by
 // signup/login below) authenticates, scoped to the account's tenant
 const auth = tok() ? {'Authorization':'Bearer '+tok()} : {};
 opts.headers = Object.assign(auth, opts.headers||{});
 const r = await fetch(path, opts);
 const body = await r.json().catch(()=>({}));
 if(!r.ok) throw new Error(body.message||r.status);
 return body;
}
async function acct(kind){
 try{
  const body = kind==='logout' ? '{}' : JSON.stringify(
    {email:$('acct-email').value.trim(), password:$('acct-pw').value});
  const out = await api('/v1/auth/'+kind, {method:'POST', body});
  if(kind==='logout'){ $('acct-state').textContent='signed out'; return; }
  $('tenant').value = out.tenant_id;
  $('acct-state').textContent = out.email+' (tenant '+out.tenant_id+')';
 }catch(e){ $('acct-state').textContent = 'auth: '+e.message; }
}
// restore an existing session on load
fetch('/v1/auth/whoami').then(r=>r.ok?r.json():null).then(w=>{
 if(w && w.key_id && w.key_id.startsWith('session:')){
  $('tenant').value = w.tenant_id;
  $('acct-state').textContent = w.key_id.slice(8)+' (tenant '+w.tenant_id+')';
 }
}).catch(()=>{});
fetch('/v1/info').then(r=>r.json()).then(i=>$('info').textContent=
  i.name+' v'+i.version).catch(()=>{});
let MANIFEST=null;
function renderTunables(cat, selId, boxId){
 // manifest-driven controls, like the reference playground: every
 // tunable the selected algorithm declares becomes an input
 const box=$(boxId); box.innerHTML='';
 if(!MANIFEST) return;
 const algo=MANIFEST[cat].algorithms.find(a=>a.id===$(selId).value);
 if(!algo) return;
 algo.tunables.forEach(t=>{
  const lab=document.createElement('label');
  lab.title=t.help||'';
  const id=`tun-${cat}-${t.name}`;
  if(t.kind==='enum'){
   lab.innerHTML=`${t.label} <select id="${id}">`+
    t.enum_values.map(v=>`<option${v===t.default?' selected':''}>${v}</option>`).join('')+
    `</select>`;
  }else if(t.kind==='bool'){
   lab.innerHTML=`${t.label} <input type="checkbox" id="${id}"${t.default?' checked':''}>`;
  }else{
   lab.innerHTML=`${t.label} <input id="${id}" size="6" value="${t.default}"`+
    (t.min!=null?` min="${t.min}" max="${t.max}"`:'')+`>`;
  }
  box.appendChild(lab);
 });
}
function tunableQuery(cat, selId){
 // collect the rendered controls into query params; defaults are omitted
 if(!MANIFEST) return '';
 const algo=MANIFEST[cat].algorithms.find(a=>a.id===$(selId).value);
 if(!algo) return '';
 const parts=[];
 algo.tunables.forEach(t=>{
  const el=$(`tun-${cat}-${t.name}`);
  if(!el) return;
  let v = t.kind==='bool' ? (el.checked?'1':'0') : el.value;
  if(String(v)!==String(t.kind==='bool'?(t.default?'1':'0'):t.default))
   parts.push(`${t.name}=${encodeURIComponent(v)}`);
 });
 return parts.length?('&'+parts.join('&')):'';
}
fetch('/v1/algorithms').then(r=>r.json()).then(m=>{
 MANIFEST=m;
 for(const [sel, cat, box] of [['text-algo','text','text-tunables'],
   ['img-algo','image','img-tunables'],['aud-algo','audio','aud-tunables']]){
  const s=$(sel);
  m[cat].algorithms.forEach(a=>{
   const o=document.createElement('option');o.value=a.id;o.textContent=a.label;
   s.appendChild(o);
  });
  s.onchange=()=>renderTunables(cat, sel, box);
  renderTunables(cat, sel, box);
 }
});

function esc(v){return String(v).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));}
function kv(obj, keys){return keys.map(k=>`<span class="kv">${k} <b>${esc(obj[k])}</b></span>`).join(' · ');}
function hexBox(h){return `<div class="hex">${h}</div>`;}

// ---- chart primitives (reference web/src/lib/components/charts/) ----------
function chartCard(title, el){
 const d=document.createElement('div');
 d.innerHTML=`<div class="kv" style="margin-top:8px">${title}</div>`;
 d.appendChild(el); return d;
}
function slotHeatmap(sig){
 // MinHashSlotHeatmap: 16x8 grid coloured by slot value
 const c=document.createElement('canvas');c.width=320;c.height=Math.ceil(sig.length/16)*20;
 const g=c.getContext('2d');
 sig.forEach((v,i)=>{
  const hue = Number(BigInt(v) % 360n);
  g.fillStyle=`hsl(${hue},60%,45%)`;
  g.fillRect((i%16)*20, Math.floor(i/16)*20, 19, 19);
 });
 return c;
}
function bitGrid(hex, w, h, cell){
 // BitGrid8x8 and friends
 const c=document.createElement('canvas');c.width=w*cell;c.height=h*cell;
 const g=c.getContext('2d');
 const bytes = hex.match(/../g).map(x=>parseInt(x,16));
 for(let i=0;i<w*h;i++){
  const bit = (bytes[i>>3] >> (i&7)) & 1;
  g.fillStyle = bit?'#58a6ff':'#21262d';
  g.fillRect((i%w)*cell, Math.floor(i/w)*cell, cell-1, cell-1);
 }
 return c;
}
function bitWheel(hex, bits){
 // SimHashBitWheel: 64 radial spokes, set bits lit
 bits = bits||64;
 const c=document.createElement('canvas');c.width=180;c.height=180;
 const g=c.getContext('2d');
 const bytes = hex.match(/../g).map(x=>parseInt(x,16));
 for(let i=0;i<bits;i++){
  const bit=(bytes[i>>3]>>(i&7))&1;
  const a0=i/bits*2*Math.PI - Math.PI/2;
  g.strokeStyle=bit?'#58a6ff':'#30363d'; g.lineWidth=bit?3:1.5;
  g.beginPath();
  g.moveTo(90+Math.cos(a0)*28, 90+Math.sin(a0)*28);
  g.lineTo(90+Math.cos(a0)*80, 90+Math.sin(a0)*80);
  g.stroke();
 }
 g.fillStyle='#8b949e';g.font='11px monospace';g.textAlign='center';
 g.fillText(bits+'b',90,94);
 return c;
}
function bitDiffStrip(hexA, hexB){
 // BitDiffStrip: XOR of two fingerprints, differing bits in red;
 // returns {el, dist, bits}
 const A=hexA.match(/../g).map(x=>parseInt(x,16));
 const B=hexB.match(/../g).map(x=>parseInt(x,16));
 const n=Math.min(A.length,B.length), bits=n*8;
 const cell=Math.max(2,Math.floor(640/bits)); let dist=0;
 const c=document.createElement('canvas');c.width=Math.min(bits*cell,640);c.height=18;
 const g=c.getContext('2d');
 for(let i=0;i<bits;i++){
  const a=(A[i>>3]>>(i&7))&1, b=(B[i>>3]>>(i&7))&1;
  if(a!==b)dist++;
  g.fillStyle = a!==b?'#f85149':(a?'#58a6ff':'#21262d');
  g.fillRect((i*cell)%640, 0, Math.max(cell-1,1), 17);
 }
 return {el:c, dist, bits};
}
function byteHistogram(hex){
 // ByteHistogram: 64-bucket distribution of fingerprint byte values
 const bytes=hex.match(/../g).map(x=>parseInt(x,16));
 const buckets=new Array(64).fill(0);
 bytes.forEach(b=>buckets[b>>2]++);
 const mx=Math.max(...buckets,1);
 const c=document.createElement('canvas');c.width=320;c.height=80;
 const g=c.getContext('2d');g.fillStyle='#58a6ff';
 buckets.forEach((v,i)=>g.fillRect(i*5,80-v/mx*76,4,v/mx*76));
 return c;
}
function embeddingBars(vec){
 // EmbeddingBars: first 128 dims, signed bars around a midline
 const v=vec.slice(0,128);
 const mx=Math.max(...v.map(Math.abs),1e-9);
 const c=document.createElement('canvas');c.width=Math.max(v.length*5,64);c.height=96;
 const g=c.getContext('2d');
 g.strokeStyle='#30363d';g.beginPath();g.moveTo(0,48);g.lineTo(c.width,48);g.stroke();
 v.forEach((x,i)=>{
  g.fillStyle=x>=0?'#58a6ff':'#f78166';
  const h=Math.abs(x)/mx*44;
  g.fillRect(i*5, x>=0?48-h:48, 4, h);
 });
 return c;
}
function tfidfBars(term_hits){
 // TfIdfBars: per-term idf (blue) and tf (orange) side by side
 const n=term_hits.length;
 const c=document.createElement('canvas');c.width=Math.max(n*64,64);c.height=110;
 const g=c.getContext('2d');
 const mi=Math.max(...term_hits.map(t=>t.idf),1e-9);
 const mt=Math.max(...term_hits.map(t=>t.tf),1e-9);
 term_hits.forEach((t,i)=>{
  g.fillStyle='#58a6ff'; g.fillRect(i*64+4, 90-t.idf/mi*80, 22, t.idf/mi*80);
  g.fillStyle='#f78166'; g.fillRect(i*64+30, 90-t.tf/mt*80, 22, t.tf/mt*80);
  g.fillStyle='#8b949e';g.font='10px monospace';g.textAlign='center';
  g.fillText(t.term.slice(0,9), i*64+32, 102);
 });
 return c;
}
function termChips(term_hits){
 // TermHitChips: contribution-weighted chips
 const d=document.createElement('span');
 term_hits.forEach(t=>{
  const s=document.createElement('span');
  s.className='kv';
  s.style.cssText='background:#21262d;border-radius:10px;padding:2px 8px;margin:2px';
  s.innerHTML=`${esc(t.term)} <b>${t.contribution.toFixed(3)}</b>`;
  d.appendChild(s);
 });
 return d;
}
function rrfBreakdown(hits, rrfK){
 // RrfBreakdown: stacked per-hit bars of the vector and BM25
 // contributions 1/(rrf_k + rank), the exact fusion math
 rrfK=rrfK||60;
 const c=document.createElement('canvas');c.width=Math.max(hits.length*56,56);c.height=120;
 const g=c.getContext('2d');
 const contrib=h=>[
  h.vector_rank!=null?1/(rrfK+h.vector_rank):0,
  h.bm25_rank!=null?1/(rrfK+h.bm25_rank):0];
 const mx=Math.max(...hits.map(h=>contrib(h)[0]+contrib(h)[1]),1e-9);
 hits.forEach((h,i)=>{
  const [v,b]=contrib(h);
  const vh=v/mx*90, bh=b/mx*90;
  g.fillStyle='#58a6ff'; g.fillRect(i*56+6, 100-vh, 40, vh);
  g.fillStyle='#d29922'; g.fillRect(i*56+6, 100-vh-bh, 40, bh);
  g.fillStyle='#8b949e';g.font='10px monospace';g.textAlign='center';
  g.fillText('#'+h.record_id, i*56+26, 112);
 });
 const legend=document.createElement('div');
 legend.className='kv';
 legend.innerHTML='<span style="color:#58a6ff">&#9632;</span> vector '+
  '<span style="color:#d29922">&#9632;</span> bm25 — height = 1/(rrf_k+rank)';
 const wrap=document.createElement('div');wrap.appendChild(c);wrap.appendChild(legend);
 return wrap;
}
function donut(counts, colors){
 // Donut: share by category (usage ops)
 const entries=Object.entries(counts); const total=entries.reduce((s,[,v])=>s+v,0)||1;
 const pal=colors||['#58a6ff','#f78166','#d29922','#3fb950','#bc8cff','#f85149'];
 const c=document.createElement('canvas');c.width=220;c.height=120;
 const g=c.getContext('2d'); let a0=-Math.PI/2;
 entries.forEach(([k,v],i)=>{
  const a1=a0+v/total*2*Math.PI;
  g.beginPath();g.strokeStyle=pal[i%pal.length];g.lineWidth=20;
  g.arc(60,60,42,a0,a1);g.stroke();a0=a1;
  g.fillStyle=pal[i%pal.length];g.fillRect(128,12+i*16,10,10);
  g.fillStyle='#8b949e';g.font='11px monospace';g.textAlign='left';
  g.fillText(`${k} ${v}`,142,21+i*16);
 });
 return c;
}
function sparkline(values, w, h){
 // Sparkline: compact series (usage over time)
 w=w||320;h=h||48;
 const c=document.createElement('canvas');c.width=w;c.height=h;
 const g=c.getContext('2d');
 const mx=Math.max(...values,1);
 g.strokeStyle='#58a6ff';g.beginPath();
 values.forEach((v,i)=>{
  const x=i/(Math.max(values.length-1,1))*(w-4)+2, y=h-4-v/mx*(h-8);
  i?g.lineTo(x,y):g.moveTo(x,y);
 });
 g.stroke();
 return c;
}
function lineChart(points, w, h){
 // LineChart: labeled time axis + filled series
 w=w||560;h=h||140;
 const c=document.createElement('canvas');c.width=w;c.height=h;
 const g=c.getContext('2d');
 if(!points.length) return c;
 const mx=Math.max(...points.map(p=>p.y),1);
 g.strokeStyle='#30363d';g.strokeRect(0.5,0.5,w-1,h-21);
 g.beginPath();g.fillStyle='rgba(88,166,255,.25)';g.strokeStyle='#58a6ff';
 points.forEach((p,i)=>{
  const x=i/(Math.max(points.length-1,1))*(w-8)+4, y=h-24-p.y/mx*(h-34);
  i?g.lineTo(x,y):g.moveTo(x,y);
 });
 g.stroke();g.lineTo(w-4,h-22);g.lineTo(4,h-22);g.fill();
 g.fillStyle='#8b949e';g.font='10px monospace';g.textAlign='left';
 g.fillText(points[0].label||'', 4, h-8);
 g.textAlign='right';g.fillText(points[points.length-1].label||'', w-4, h-8);
 g.fillText('max '+mx, w-4, 12);
 return c;
}
function f32FromHex(hex){
 // decode little-endian f32s from a hex slice (multihash histogram)
 const bytes=hex.match(/../g).map(x=>parseInt(x,16));
 const dv=new DataView(new Uint8Array(bytes).buffer);
 const out=[];
 for(let i=0;i+4<=bytes.length;i+=4) out.push(dv.getFloat32(i,true));
 return out;
}

async function textFp(body){
 const algo=$('text-algo').value;
 const q=`algorithm=${algo}${tunableQuery('text','text-algo')}`;
 const ins = await api(`/v1/pipeline/inspect/text?${q}&tenant_id=${ten()}`,
   {method:'POST', body});
 const fp = await api(`/v1/ingest/text/${ten()}/${RID++}?${q}`,
   {method:'POST', body});
 return {ins, fp, algo};
}
async function runText(){
 const out=$('text-out'); out.innerHTML='…';
 try{
  const {ins, fp, algo} = await textFp($('text-input').value);
  out.innerHTML = `<div class="row">${kv(fp,['algorithm','fingerprint_bytes','config_hash','record_id'])}</div>`
   + `<div class="kv">canonicalized</div><div class="hex">${ins.canonicalized}</div>`
   + `<div class="kv">tokens (${ins.tokens.length})</div><div class="hex">${ins.tokens.join(' ')}</div>`
   + `<div class="kv">shingles (${ins.shingles.length})</div><div class="hex">${ins.shingles.slice(0,40).join(' | ')}${ins.shingles.length>40?' …':''}</div>`
   + hexBox(fp.fingerprint_hex.slice(0,512)+(fp.fingerprint_hex.length>512?'…':''));
  if(algo==='minhash'||algo==='lsh')
   out.appendChild(chartCard('MinHash slot heatmap', slotHeatmap(ins.signature_u64)));
  if(algo.startsWith('simhash')){
   out.appendChild(chartCard('SimHash bit wheel', bitWheel(fp.fingerprint_hex.slice(0,16))));
   out.appendChild(chartCard('SimHash bits', bitGrid(fp.fingerprint_hex.slice(0,16),8,8,16)));
  }
  if(algo==='tlsh')
   out.appendChild(chartCard('TLSH byte histogram', byteHistogram(fp.fingerprint_hex)));
  if(fp.embedding)
   out.appendChild(chartCard('embedding (first 128 dims)', embeddingBars(fp.embedding)));
  // side-by-side diff against the compare box
  const cmp=$('text-compare').value.trim();
  if(cmp){
   const b = await textFp(cmp);
   if(algo==='minhash'||algo==='lsh'){
    const agree = ins.signature_u64.filter((v,i)=>b.ins.signature_u64[i]===v).length;
    out.appendChild(chartCard(
     `compare: ${agree}/${ins.signature_u64.length} slots agree — estimated Jaccard ${(agree/ins.signature_u64.length).toFixed(3)}`,
     slotHeatmap(b.ins.signature_u64)));
   }
   const strip = bitDiffStrip(fp.fingerprint_hex, b.fp.fingerprint_hex);
   out.appendChild(chartCard(
    `bit diff: ${strip.dist}/${strip.bits} bits differ (${(100*strip.dist/strip.bits).toFixed(1)}%)`,
    strip.el));
  }
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}

async function imageFp(bytes, algo){
 const tq = tunableQuery('image','img-algo');
 const ins = await api(`/v1/pipeline/inspect/image?tenant_id=${ten()}${tq}`,
   {method:'POST', body:bytes});
 const fp = await api(
   `/v1/ingest/image/${ten()}/${RID++}?algorithm=${algo}${tq}`
   + (algo==='semantic'?'&return_embedding=1':''),
   {method:'POST', body:bytes});
 return {ins, fp};
}
async function runImage(){
 const f=$('img-file').files[0]; const out=$('img-out');
 if(!f){out.textContent='pick a file';return;}
 out.innerHTML='…';
 const bytes = await f.arrayBuffer();
 const algo=$('img-algo').value;
 try{
  const {ins, fp} = await imageFp(bytes, algo);
  out.innerHTML = `<div class="row">${kv(fp,['algorithm','fingerprint_bytes','record_id'])}</div>`
   + `<div class="row">
    <span><div class="kv">original ${ins.width}x${ins.height}</div>
      <img class="stage" src="data:image/png;base64,${ins.original_png_b64}" height="128"></span>
    <span><div class="kv">32x32 gray (pHash DCT input)</div>
      <img class="stage" src="data:image/png;base64,${ins.gray32_png_b64}" width="96" height="96"></span>
    <span><div class="kv">8x8 gray (aHash, mean ${ins.ahash_mean})</div>
      <img class="stage" src="data:image/png;base64,${ins.gray8_png_b64}" width="96" height="96"></span>
   </div>` + hexBox(fp.fingerprint_hex);
  if(algo==='multi'){
   // 536-byte bundle: phash/dhash/ahash u64s + 64xf32 hist + 256 block u8
   const row=document.createElement('div'); row.className='row';
   [['pHash',0],['dHash',16],['aHash',32]].forEach(([nm,off])=>
    row.appendChild(chartCard(nm+' bits',
     bitGrid(fp.fingerprint_hex.slice(off,off+16),8,8,12))));
   out.appendChild(row);
   const hist=f32FromHex(fp.fingerprint_hex.slice(48,48+64*8));
   out.appendChild(chartCard('global luma histogram (64 bins, L1-normalized)',
    embeddingBars(hist.map(x=>x))));
   out.appendChild(chartCard('block means byte histogram',
    byteHistogram(fp.fingerprint_hex.slice(48+64*8))));
  } else if(fp.fingerprint_bytes>=8 && algo!=='semantic'){
   out.appendChild(chartCard(algo+' bits', bitGrid(fp.fingerprint_hex.slice(0,16),8,8,16)));
  }
  if(fp.embedding)
   out.appendChild(chartCard('CLIP-style embedding (first 128 dims)',
    embeddingBars(fp.embedding)));
  // side-by-side diff against the compare file
  const cf=$('img-compare').files[0];
  if(cf){
   const b = await imageFp(await cf.arrayBuffer(), algo);
   const strip = bitDiffStrip(fp.fingerprint_hex.slice(0,96),
                              b.fp.fingerprint_hex.slice(0,96));
   out.appendChild(chartCard(
    `compare (hash components): ${strip.dist}/${strip.bits} bits differ`,
    strip.el));
   if(algo==='multi'){
    const res = await api('/v1/query', {method:'POST', body: JSON.stringify(
     {tenant_id: ten(), modality:'image', k:3,
      fingerprint_hex: b.fp.fingerprint_hex, algorithm: fp.algorithm})});
    const mine=(res.hits||[]).find(h=>h.record_id===fp.record_id);
    const d=document.createElement('div'); d.className='kv';
    d.innerHTML = `weighted multi-hash similarity vs compare image: <b>${
      mine?(mine.score*100).toFixed(1)+'%':'n/a'}</b> (phash .4 / dhash .3 / ahash .1 / global .1 / block .1)`;
    out.appendChild(d);
   }
  }
  // Hamming search over previously ingested fingerprints of this algorithm
  const sim=document.createElement('div');
  sim.innerHTML=`<button class="go" style="margin-top:8px">Find similar</button>
    <span id="img-sim" class="kv"></span>`;
  sim.querySelector('button').onclick=async()=>{
   try{
    const res = await api('/v1/query', {method:'POST', body: JSON.stringify(
     {tenant_id: ten(), modality:'image', k:5,
      fingerprint_hex: fp.fingerprint_hex, algorithm: fp.algorithm})});
    const hits=(res.hits||[]).map(h=>
      `#${h.record_id} (${(h.score*100).toFixed(1)}%)`).join('  ');
    sim.querySelector('#img-sim').textContent = hits || 'no matches';
   }catch(e){ sim.querySelector('#img-sim').textContent='error: '+e.message; }
  };
  out.appendChild(sim);
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}

async function runAudio(){
 const f=$('aud-file').files[0]; const out=$('aud-out');
 if(!f){out.textContent='pick a file';return;}
 out.innerHTML='decoding…';
 const ac = new (window.AudioContext||window.webkitAudioContext)({sampleRate:8000});
 const buf = await ac.decodeAudioData(await f.arrayBuffer());
 const mono = buf.getChannelData(0);
 const body = new Float32Array(mono).buffer;
 const algo=$('aud-algo').value;
 try{
  const tq = tunableQuery('audio','aud-algo');
  // the PN watermark key is a per-tenant SECRET and rides a header,
  // never the query string (keys in URLs leak into logs)
  const wkey = $('aud-wmkey').value.trim();
  const headers = (algo==='watermark' && wkey) ? {'X-Watermark-Key': wkey} : {};
  // watermark has no inspect stages (detection-only); show the shared
  // DSP stages (envelope/spectrograms/constellation) via the default
  const insAlgo = algo==='watermark' ? 'wang' : algo;
  const ins = await api(`/v1/pipeline/inspect/audio?sample_rate=8000&algorithm=${insAlgo}&tenant_id=${ten()}${tq}`,
    {method:'POST', body, headers});
  const fp = await api(`/v1/ingest/audio/${ten()}/${RID++}?sample_rate=8000&algorithm=${algo}${tq}`,
    {method:'POST', body, headers});
  out.innerHTML = `<div class="row">${kv(ins,['duration_secs','total_peaks','total_landmarks'])}</div>`
   + `<div class="row">
      <span><div class="kv">linear spectrogram</div>
       <img class="stage" src="data:image/png;base64,${ins.lin_spec_png_b64}" width="256"></span>
      <span><div class="kv">mel spectrogram</div>
       <img class="stage" src="data:image/png;base64,${ins.mel_spec_png_b64}" width="256"></span>
     </div>`;
  // envelope
  const env=document.createElement('canvas');env.width=512;env.height=80;
  const g=env.getContext('2d');g.strokeStyle='#58a6ff';g.beginPath();
  ins.envelope.forEach((v,i)=>{const y=40-v*38;g.moveTo(i*2,40+(40-y));g.lineTo(i*2,y);});
  g.stroke(); out.appendChild(env);
  // peak constellation + landmark lines
  const c=document.createElement('canvas');c.width=512;c.height=200;
  const g2=c.getContext('2d');
  const tmax = Math.max(...ins.peaks.map(p=>p.t_ms),1);
  g2.strokeStyle='rgba(88,166,255,.35)';
  ins.landmarks.slice(0,200).forEach(l=>{g2.beginPath();
   g2.moveTo(l.t1_ms/tmax*500, 195-l.f1_hz/4000*190);
   g2.lineTo(l.t2_ms/tmax*500, 195-l.f2_hz/4000*190);g2.stroke();});
  g2.fillStyle='#f78166';
  ins.peaks.forEach(p=>g2.fillRect(p.t_ms/tmax*500-1, 195-p.freq_hz/4000*190-1, 3,3));
  out.appendChild(c);
  if(fp.fingerprint_hex){
   out.insertAdjacentHTML('beforeend', hexBox(fp.fingerprint_hex.slice(0,512)+'…'));
   if(algo==='haitsma'){
    // one row per frame, 32 sub-fingerprint bits each
    const frames=Math.min(Math.floor(fp.fingerprint_hex.length/8),64);
    out.appendChild(chartCard(`Haitsma sub-fingerprints (first ${frames} frames x 32 bits)`,
     bitGrid(fp.fingerprint_hex.slice(0,frames*8),32,frames,6)));
   }
   out.appendChild(chartCard('fingerprint byte histogram',
    byteHistogram(fp.fingerprint_hex.slice(0,4096))));
  }
  else out.insertAdjacentHTML('beforeend', `<div class="row">${kv(fp,['detected','confidence'])}</div>`);
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}

async function runQuery(){
 const out=$('q-out'); out.innerHTML='…';
 try{
  const body={tenant_id:ten(),modality:'text',k:parseInt($('q-k').value)||10,
              terms:$('q-terms').value.split(/\s+/).filter(x=>x)};
  const vtxt=$('q-vector').value.trim();
  if(vtxt) body.vector = vtxt.split(/[\s,]+/).filter(x=>x).map(Number);
  const falg=$('q-filter-algo').value.trim();
  if(falg) body.filter = {algorithm: falg};
  const res=await api('/v1/query?explain='+($('q-explain').checked?1:0),
    {method:'POST',body:JSON.stringify(body)});
  if(!res.hits.length){ out.innerHTML='<div class="kv">no hits</div>'; return; }
  out.innerHTML = res.hits.map(h=>{
   return `<div class="row">${kv(h,['record_id','score','source'])}`
    + (h.vector_score!=null?`<span class="kv">vec <b>${h.vector_score.toFixed(4)}</b> (rank ${h.vector_rank})</span>`:'')
    + (h.bm25_score!=null?`<span class="kv">bm25 <b>${h.bm25_score.toFixed(4)}</b> (rank ${h.bm25_rank})</span>`:'')
    + `</div>`;}).join('');
  const fused = res.hits.filter(h=>h.vector_rank!=null||h.bm25_rank!=null);
  if(fused.length)
   out.appendChild(chartCard('RRF breakdown', rrfBreakdown(fused)));
  const th = res.hits.find(h=>h.term_hits&&h.term_hits.length);
  if(th){
   out.appendChild(chartCard('term hits (top hit)', termChips(th.term_hits)));
   out.appendChild(chartCard('tf / idf per term (top hit)', tfidfBars(th.term_hits)));
  }
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}

async function describeRec(){
 const out=$('r-out');
 try{
  const d=await api(`/v1/records/${ten()}/${$('r-id').value}`);
  out.innerHTML=`<div class="row">${kv(d,['record_id','modality','algorithm','fingerprint_bytes','has_embedding'])}</div>`;
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}
async function runBulk(){
 const lines = $('bulk-input').value.split('\n').map(s=>s.trim()).filter(Boolean);
 const algo = $('bulk-algo').value; let rid = parseInt($('bulk-start').value)||1000;
 const out = $('bulk-out'); out.textContent = '';
 const t0 = performance.now(); let ok = 0, fail = 0; const first = rid;
 // the batch route: one WAL commit per 256-line chunk instead of one
 // request (and one fsync) per line — measured 5.4x server-side
 for(let i = 0; i < lines.length; i += 256){
  const chunk = lines.slice(i, i + 256);
  const body = chunk.map(l => JSON.stringify({record_id: rid++, text: l})).join('\n');
  try{
   const r = await api(`/v1/ingest/text/batch/${ten()}?algorithm=${algo}`,
             {method:'POST', body});
   ok += r.count; fail += (r.errors||[]).length;
  }catch(e){ fail += chunk.length; }
  out.textContent = `${ok+fail}/${lines.length}…`;
 }
 const dt = ((performance.now()-t0)/1000).toFixed(2);
 out.innerHTML = `<div class="kv"><b>${ok}</b> ingested, ${fail} failed in ${dt}s`
   + ` (${(ok/Math.max(dt,0.01)).toFixed(0)}/s) — ids ${first}…${rid-1}</div>`;
}
async function loadUsage(){
 const out = $('u-out');
 try{
  const u = await api('/v1/admin/usage?limit='+(parseInt($('u-limit').value)||200));
  const evs = u.events||[];
  const byOp = {}, byAlgo = {}, byMod = {};
  evs.forEach(e=>{
   byOp[e.op]=(byOp[e.op]||0)+1;
   if(e.algorithm) byAlgo[e.algorithm]=(byAlgo[e.algorithm]||0)+1;
   if(e.modality) byMod[e.modality]=(byMod[e.modality]||0)+1;
  });
  out.innerHTML = `<div class="kv">${evs.length} events</div>`;
  if(evs.length){
   const row=document.createElement('div'); row.className='row';
   row.appendChild(chartCard('by op', donut(byOp)));
   if(Object.keys(byMod).length) row.appendChild(chartCard('by modality', donut(byMod)));
   out.appendChild(row);
   if(Object.keys(byAlgo).length){
    // per-algorithm breakdown (UsageEvent.algorithm)
    const entries=Object.entries(byAlgo).sort((a,b)=>b[1]-a[1]).slice(0,12);
    const c=document.createElement('canvas');c.width=560;c.height=entries.length*22+6;
    const g=c.getContext('2d');
    const mx=Math.max(...entries.map(([,v])=>v),1);
    entries.forEach(([k,v],i)=>{
     g.fillStyle='#58a6ff'; g.fillRect(170, i*22+4, v/mx*380, 16);
     g.fillStyle='#8b949e'; g.font='11px monospace'; g.textAlign='right';
     g.fillText(k.slice(0,24), 164, i*22+16);
     g.textAlign='left'; g.fillText(String(v), 174+v/mx*380, i*22+16);
    });
    out.appendChild(chartCard('by algorithm', c));
   }
   // request timeline: bucket events into 40 time slices
   const ts=evs.map(e=>e.ts).filter(Boolean);
   if(ts.length>1){
    const t0=Math.min(...ts), t1=Math.max(...ts), nb=40;
    const buckets=new Array(nb).fill(0);
    ts.forEach(t=>buckets[Math.min(nb-1,Math.floor((t-t0)/Math.max(t1-t0,1)*nb))]++);
    out.appendChild(chartCard('requests over time', lineChart(
     buckets.map((y,i)=>({y, label: i===0?new Date(t0).toISOString().slice(11,19)
       : i===nb-1?new Date(t1).toISOString().slice(11,19):''})))));
    out.appendChild(chartCard('sparkline', sparkline(buckets)));
   }
   // latency distribution
   const lats=evs.map(e=>e.elapsed_ms||0);
   const lmax=Math.max(...lats,1), lb=new Array(32).fill(0);
   lats.forEach(l=>lb[Math.min(31,Math.floor(l/lmax*32))]++);
   out.appendChild(chartCard(`latency histogram (max ${lmax.toFixed(1)} ms)`,
    sparkline(lb, 320, 48)));
  }
  const rows = evs.slice(-50).reverse().map(e=>
   `<tr><td>${new Date(e.ts).toISOString().slice(11,19)}</td><td>${esc(e.tenant_id)}</td>`
   + `<td>${esc(e.key_id||'')}</td><td>${esc(e.op)}</td><td>${esc(e.modality||'')}</td>`
   + `<td>${esc(e.algorithm||'')}</td><td>${esc(e.status)}</td>`
   + `<td>${esc(e.bytes_in)}</td><td>${(e.elapsed_ms||0).toFixed(1)}ms</td></tr>`).join('');
  // insertAdjacentHTML: innerHTML += would reserialize and blank the canvases
  out.insertAdjacentHTML('beforeend',
   `<table style="font-size:12px;border-spacing:8px 2px"><tr><th>time</th><th>tenant</th>`
   + `<th>key</th><th>op</th><th>modality</th><th>algorithm</th><th>status</th><th>bytes</th><th>ms</th></tr>${rows}</table>`);
 }catch(e){ out.textContent = 'usage: '+e.message; }
}
async function createKey(){
 const out=$('k-out');
 try{
  const body={tenant_id:parseInt($('k-tenant').value)||0};
  if($('k-id').value) body.key_id=$('k-id').value;
  const k=await api('/v1/admin/keys',{method:'POST',body:JSON.stringify(body)});
  out.innerHTML=`<div class="kv">token (copy now — shown once):</div><div class="hex">${esc(k.token)}</div>`
   +`<div class="row">${kv(k,['key_id','tenant_id','prefix'])}</div>`;
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}
async function listKeys(){
 const out=$('k-out');
 try{
  const r=await api('/v1/admin/keys');
  out.innerHTML = r.keys.length? r.keys.map((k,i)=>
   `<div class="row">${kv(k,['key_id','tenant_id','prefix'])}
    <button class="go" style="background:#da3633;padding:2px 8px"
     data-ki="${i}">revoke</button></div>`).join('')
   : '<div class="kv">no issued keys</div>';
  // stored key ids are attacker-controlled strings: no inline handlers
  out.querySelectorAll('button[data-ki]').forEach(b=>
   b.addEventListener('click', ()=>revokeKey(r.keys[+b.dataset.ki].key_id)));
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}
async function revokeKey(id){
 try{ await api('/v1/admin/keys/'+encodeURIComponent(id),{method:'DELETE'}); listKeys(); }
 catch(e){ $('k-out').innerHTML=`<div class="hex">error: ${e.message}</div>`; }
}
async function listRecs(offset){
 const out=$('r-out');
 try{
  const r=await api(`/v1/records/${ten()}?offset=${offset}&limit=25`);
  out.innerHTML=`<div class="kv"><b>${r.total}</b> records (showing ${r.records.length} from ${r.offset})</div>`
   + r.records.map(x=>`<div class="row">${kv(x,['record_id','modality','algorithm','fingerprint_bytes','has_embedding'])}</div>`).join('');
  if(r.offset + r.records.length < r.total){
   const more=document.createElement('button');
   more.className='go'; more.textContent='next page';
   more.addEventListener('click', ()=>listRecs(r.offset + r.records.length));
   out.appendChild(more);
  }
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}
async function deleteRec(){
 const out=$('r-out');
 try{ await api(`/v1/records/${ten()}/${$('r-id').value}`,{method:'DELETE'});
  out.innerHTML='<div class="kv">deleted</div>';
 }catch(e){out.innerHTML=`<div class="hex">error: ${e.message}</div>`;}
}
</script>
</body>
</html>
"""
