"""Dashboard SPA: a single-file vanilla-JS client over the JSON API.

Ref analog: the reference's React/TS dashboard client
(dashboard/client/src/ — jobs/actors/nodes/metrics/serve pages backed by
the same REST endpoints). Re-design: no build toolchain — one hash-routed
HTML document served by dashboard.py, reading /api/* every 2 s. Pages:
overview, nodes, actors, tasks (+summary), objects, placement groups,
jobs, metrics, events (the cluster event log), serve, timeline (SVG
lanes over ray_tpu_torch.tracing events).

Colors follow a validated light/dark palette (categorical slots for
timeline lanes, status colors only for alive/dead state, always beside a
text label — never color alone).

A copy of ``ray_tpu.dashboard_ui``; the overview's accelerator tile reads
the cluster's ``GPU`` resource where the reference's reads ``TPU``.
"""

INDEX_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f0efec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --border: #d8d7d2;
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --good: #008300; --serious: #e34948; --warning: #eda100;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #383835;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --border: #44443f;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --good: #1baf7a; --serious: #e66767; --warning: #c98500;
  }
}
* { box-sizing: border-box; }
body { font-family: ui-monospace, Menlo, monospace; margin: 0;
       background: var(--surface-1); color: var(--text-primary); }
nav { display: flex; gap: 2px; padding: 8px 12px; flex-wrap: wrap;
      border-bottom: 1px solid var(--border); position: sticky; top: 0;
      background: var(--surface-1); }
nav a { color: var(--text-secondary); text-decoration: none;
        padding: 4px 10px; border-radius: 6px; font-size: 13px; }
nav a.active { background: var(--surface-2); color: var(--text-primary); }
main { padding: 16px; max-width: 1200px; }
h2 { font-size: 15px; margin: 4px 0 12px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 16px; }
.tile { background: var(--surface-2); border-radius: 8px;
        padding: 10px 16px; min-width: 120px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .k { font-size: 11px; color: var(--text-secondary); }
table { border-collapse: collapse; width: 100%; font-size: 12px; }
th { text-align: left; color: var(--text-secondary); font-weight: 500;
     border-bottom: 1px solid var(--border); padding: 4px 8px;
     position: sticky; top: 41px; background: var(--surface-1); }
td { border-bottom: 1px solid var(--border); padding: 4px 8px;
     max-width: 360px; overflow: hidden; text-overflow: ellipsis;
     white-space: nowrap; }
.status { display: inline-flex; align-items: center; gap: 5px; }
.dot { width: 8px; height: 8px; border-radius: 50%; display: inline-block; }
.ok .dot { background: var(--good); } .bad .dot { background: var(--serious); }
.warn .dot { background: var(--warning); }
#tl-wrap { overflow-x: auto; border: 1px solid var(--border);
           border-radius: 8px; background: var(--surface-1); }
.legend { display: flex; gap: 16px; margin: 8px 0; font-size: 12px;
          color: var(--text-secondary); align-items: center; }
.legend .sw { width: 10px; height: 10px; border-radius: 3px;
              display: inline-block; margin-right: 5px; }
#tooltip { position: fixed; pointer-events: none; display: none;
           background: var(--surface-2); color: var(--text-primary);
           border: 1px solid var(--border); border-radius: 6px;
           padding: 6px 9px; font-size: 12px; z-index: 10; }
.muted { color: var(--text-secondary); font-size: 12px; }
input[type=search] { background: var(--surface-2); border: 1px solid
  var(--border); color: var(--text-primary); border-radius: 6px;
  padding: 4px 8px; margin-bottom: 10px; font: inherit; }
</style></head>
<body>
<nav id="nav"></nav>
<main id="main"></main>
<div id="tooltip"></div>
<script>
"use strict";
const PAGES = ["overview","nodes","actors","tasks","objects",
               "placement_groups","jobs","metrics","events","serve",
               "timeline"];
const $ = (s) => document.querySelector(s);
const esc = (x) => String(x ?? "").replace(/[&<>]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
let timer = null, filterText = "";

function nav() {
  const page = location.hash.replace("#","") || "overview";
  $("#nav").innerHTML = PAGES.map(p =>
    `<a href="#${p}" class="${p===page?"active":""}">${p.replace("_"," ")}`
    + `</a>`).join("");
  return page;
}
async function j(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(url + " -> " + r.status);
  return r.json();
}
function statusCell(s) {
  const up = ["ALIVE","RUNNING","READY","FINISHED","CREATED","INFO","ok",
              true];
  const bad = ["DEAD","FAILED","LOST","ERROR","error"];
  const cls = up.includes(s) ? "ok" : (bad.includes(s) ? "bad" : "warn");
  return `<span class="status ${cls}"><span class="dot"></span>`
       + `${esc(s)}</span>`;
}
function table(rows, cols, statusCols) {
  statusCols = statusCols || [];
  const f = filterText.toLowerCase();
  const shown = f ? rows.filter(r =>
    JSON.stringify(r).toLowerCase().includes(f)) : rows;
  return `<input type="search" placeholder="filter…" value="${esc(filterText)}"
    oninput="filterText=this.value;render(false)">
    <div class="muted">${shown.length} of ${rows.length} rows</div>
    <table><tr>${cols.map(c=>`<th>${c}</th>`).join("")}</tr>` +
    shown.slice(0, 200).map(r => "<tr>" + cols.map(c => {
      let v = r[c];
      if (v && typeof v === "object") v = JSON.stringify(v);
      return "<td>" + (statusCols.includes(c) ? statusCell(r[c])
                                              : esc(v)) + "</td>";
    }).join("") + "</tr>").join("") + "</table>";
}
function tiles(list) {
  return `<div class="tiles">` + list.map(([k, v]) =>
    `<div class="tile"><div class="v">${esc(v)}</div>` +
    `<div class="k">${esc(k)}</div></div>`).join("") + `</div>`;
}

const RENDER = {
  async overview() {
    const [c, s] = await Promise.all([j("/api/cluster"),
                                      j("/api/summary/tasks")]);
    const rt = c.resources_total || {}, ra = c.resources_available || {};
    const states = Object.entries(s.by_state || {})
      .map(([k, v]) => `${k}: ${v}`).join("  ") || "none";
    return `<h2>cluster</h2>` + tiles([
      ["nodes", c.nodes],
      ["CPU avail / total", `${ra.CPU ?? 0} / ${rt.CPU ?? 0}`],
      ["GPU avail / total", `${ra.GPU ?? 0} / ${rt.GPU ?? 0}`],
      ["tasks seen", s.total ?? 0],
    ]) + `<h2>task states</h2><div class="muted">${esc(states)}</div>`;
  },
  async nodes() {
    return `<h2>nodes</h2>` + table(await j("/api/nodes"),
      ["node_idx","alive","is_remote","resources_total",
       "resources_available","labels"], ["alive"]);
  },
  async actors() {
    return `<h2>actors</h2>` + table(await j("/api/actors"),
      ["actor_id","class_name","name","state","node_idx","pid",
       "num_restarts"], ["state"]);
  },
  async tasks() {
    const [rows, sum] = await Promise.all([j("/api/tasks"),
                                           j("/api/summary/tasks")]);
    const byState = {};
    for (const counts of Object.values(sum.by_func_name || {}))
      for (const [st, n] of Object.entries(counts))
        byState[st] = (byState[st] || 0) + n;
    const states = Object.entries(byState);
    const enriched = rows.map(r => {
      const ph = r.phase_ms || {};
      const f = v => v === undefined ? "" : v.toFixed(1);
      return {...r, sched_wait_ms: f(ph.sched_wait),
              arg_fetch_ms: f(ph.arg_fetch), exec_ms: f(ph.exec),
              e2e_ms: f(ph.e2e),
              straggler: r.straggler ? "STRAGGLER" : ""};
    });
    return `<h2>tasks</h2>` + (states.length ? tiles(states) : "") +
      table(enriched, ["task_id","name","state","node_idx","worker_id",
                   "sched_wait_ms","arg_fetch_ms","exec_ms","e2e_ms",
                   "straggler"], ["state"]);
  },
  async objects() {
    return `<h2>objects</h2>` + table(await j("/api/objects"),
      ["object_id","size_bytes","node_idx","spilled","pinned"]);
  },
  async placement_groups() {
    return `<h2>placement groups</h2>` +
      table(await j("/api/placement_groups"),
            ["pg_id","name","strategy","state","bundles"], ["state"]);
  },
  async jobs() {
    return `<h2>jobs</h2>` + table(await j("/api/jobs"),
      ["job_id","entrypoint","status","submitted_at","message"],
      ["status"]);
  },
  async metrics() {
    const rows = await j("/api/metrics");
    return `<h2>metrics</h2>` + table(rows,
      ["name","type","tags","value","description"]);
  },
  async events() {
    const rows = await j("/api/cluster_events");
    rows.reverse();  // newest first
    for (const r of rows)
      r.when = new Date(r.ts * 1000).toLocaleTimeString();
    const bySev = {};
    for (const r of rows) bySev[r.severity] = (bySev[r.severity]||0) + 1;
    return `<h2>cluster events</h2>` +
      tiles(Object.entries(bySev)) +
      table(rows, ["when","severity","type","source","node_idx",
                   "entity_id","message"], ["severity"]);
  },
  async serve() {
    let apps;
    try { apps = await j("/api/serve/applications"); }
    catch (e) { return `<h2>serve</h2><div class="muted">serve not `
                     + `running</div>`; }
    return `<h2>serve deployments</h2>` + table(apps,
      ["app","deployment","target_replicas","running_replicas","version"],
      []);
  },
  async timeline() {
    const ev = (await j("/api/timeline")).filter(e => e.ph === "X");
    if (!ev.length) return `<h2>timeline</h2>` +
      `<div class="muted">no complete-span events yet</div>`;
    const t0 = Math.min(...ev.map(e => e.ts));
    const t1 = Math.max(...ev.map(e => e.ts + (e.dur || 0)));
    const lanes = [...new Set(ev.map(e => `${e.pid}/${e.tid}`))].sort();
    const CATS = ["task","span","actor"];
    const color = (e) => {
      const c = (e.cat || "task").toLowerCase();
      const i = CATS.indexOf(CATS.find(k => c.includes(k)) ?? "task");
      return `var(--series-${(i < 0 ? 0 : i) + 1})`;
    };
    const W = 1040, H = lanes.length * 26 + 30, L = 150;
    const sx = (t) => L + (t - t0) / Math.max(t1 - t0, 1) * (W - L - 16);
    let bars = "";
    for (const e of ev.slice(-500)) {
      const y = lanes.indexOf(`${e.pid}/${e.tid}`) * 26 + 24;
      const x = sx(e.ts), w = Math.max(sx(e.ts + (e.dur || 0)) - x, 2);
      bars += `<rect x="${x.toFixed(1)}" y="${y}" width="${w.toFixed(1)}"
        height="14" rx="4" fill="${color(e)}" data-tip="${esc(e.name)}
        — ${((e.dur||0)/1000).toFixed(2)} ms"></rect>`;
    }
    const labels = lanes.map((l, i) =>
      `<text x="4" y="${i * 26 + 35}" fill="var(--text-secondary)"
       font-size="11">${esc(l.length > 22 ? l.slice(0, 22) + "…" : l)}
       </text>`).join("");
    return `<h2>timeline <span class="muted">(${ev.length} events,
      ${((t1 - t0) / 1e6).toFixed(2)} s window)</span></h2>
      <div class="legend">
        <span><span class="sw" style="background:var(--series-1)"></span>
        task</span>
        <span><span class="sw" style="background:var(--series-2)"></span>
        span</span>
        <span><span class="sw" style="background:var(--series-3)"></span>
        actor</span></div>
      <div id="tl-wrap"><svg width="${W}" height="${H}"
        font-family="inherit">${labels}${bars}</svg></div>`;
  },
};

async function render(resetFilter = true) {
  if (resetFilter) filterText = "";
  const page = nav();
  try {
    $("#main").innerHTML = await (RENDER[page] || RENDER.overview)();
  } catch (e) {
    $("#main").innerHTML = `<div class="muted">error: ${esc(e)}</div>`;
  }
}
window.addEventListener("hashchange", () => render());
document.addEventListener("mousemove", (ev) => {
  const tgt = ev.target.closest("[data-tip]");
  const tip = $("#tooltip");
  if (tgt) {
    tip.style.display = "block";
    tip.textContent = tgt.getAttribute("data-tip");
    tip.style.left = (ev.clientX + 14) + "px";
    tip.style.top = (ev.clientY + 10) + "px";
  } else tip.style.display = "none";
});
render();
timer = setInterval(() => {
  if (!document.hidden && !filterText) render(false);
}, 2000);
</script></body></html>"""
