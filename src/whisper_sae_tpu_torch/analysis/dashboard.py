"""Static HTML dashboard over the feature-analysis outputs (a copy of
``whisper_sae_tpu/analysis/dashboard.py``: the same HTML for the same
reports).

Renders ``summary.json`` + ``features/feature_*.json`` (written by
:class:`whisper_sae_tpu_torch.analysis.FeatureReport`, the reference's
feature_viz report layout) — and, when present, the audio-extraction
clip tree (``feature_{i:05d}/rank{r:02d}_act{v:.3f}.wav`` +
``manifest.json``, reference audio_extraction.py layout) — into ONE
self-contained ``dashboard.html``: no dependencies, no network, plain
<audio> elements with relative hrefs so the file works straight off the
output directory.

The reference ships its visualization as a notebook artifact only
(notebooks/ holds a rendered PNG); this makes the same inspection loop a
build artifact of the analyze job (``launcher analyze --dashboard``).
"""

from __future__ import annotations

import html
import json
import os
import re
from pathlib import Path

_CSS = """
:root { --fg: #1a1a1a; --bg: #ffffff; --muted: #6b6b6b; --line: #e3e3e3;
        --accent: #3b6ea5; --panel: #f7f7f7; }
@media (prefers-color-scheme: dark) {
  :root { --fg: #e8e8e8; --bg: #16181c; --muted: #9a9a9a; --line: #2e3238;
          --accent: #7aa5d2; --panel: #1e2126; }
}
* { box-sizing: border-box; }
body { margin: 2rem auto; max-width: 72rem; padding: 0 1rem;
       font: 15px/1.5 system-ui, sans-serif; color: var(--fg);
       background: var(--bg); }
h1 { font-size: 1.4rem; } h2 { font-size: 1.05rem; }
.stats { display: flex; gap: 2.5rem; flex-wrap: wrap; margin: 1rem 0 2rem; }
.stat .v { font-size: 1.5rem; font-weight: 600; font-variant-numeric: tabular-nums; }
.stat .k { color: var(--muted); font-size: .85rem; }
table { border-collapse: collapse; width: 100%; font-variant-numeric: tabular-nums; }
th, td { text-align: left; padding: .35rem .6rem; border-bottom: 1px solid var(--line); }
th { color: var(--muted); font-weight: 500; font-size: .85rem; }
td.num, th.num { text-align: right; }
.bar { background: var(--line); border-radius: 2px; height: 8px; width: 120px; }
.bar > span { display: block; height: 100%; border-radius: 2px;
              background: var(--accent); }
details { margin: .25rem 0; }
summary { cursor: pointer; padding: .3rem 0; }
.feature { background: var(--panel); border: 1px solid var(--line);
           border-radius: 6px; padding: .4rem .8rem; margin: .5rem 0; }
audio { height: 28px; vertical-align: middle; }
.muted { color: var(--muted); }
"""


def _fmt(v, digits=3):
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{digits}f}"
    return str(v)


def _feature_panel(report: dict, out_dir: Path, clip_dir: Path | None) -> str:
    fi = report["feature_idx"]
    stats = report.get("stats", {})
    rows = []
    clips = {}
    if clip_dir is not None:
        fdir = clip_dir / f"feature_{fi:05d}"
        if fdir.is_dir():
            # the extractor skips ranks whose audio failed to load, so the
            # rank comes from the filename, not enumeration order
            for wav in sorted(fdir.glob("rank*.wav")):
                m = re.match(r"rank(\d+)", wav.name)
                if m:
                    clips[int(m.group(1))] = os.path.relpath(wav, out_dir)
    for rank, ex in enumerate(report.get("top_examples", [])):
        audio = ""
        if rank in clips:
            audio = (
                f'<audio controls preload="none" '
                f'src="{html.escape(clips[rank])}"></audio>'
            )
        tr = ex.get("transcription")
        rows.append(
            "<tr>"
            f'<td class="num">{rank}</td>'
            f'<td class="num">{_fmt(ex.get("activation_value"))}</td>'
            f'<td class="num">{ex.get("sample_idx")}</td>'
            f'<td class="num">{_fmt(ex.get("timestamp_ms"), 0)}</td>'
            f'<td>{html.escape(tr) if tr else "<span class=muted>—</span>"}</td>'
            f"<td>{audio}</td>"
            "</tr>"
        )
    interp = ""
    if "interpretation" in report:
        it = report["interpretation"]
        interp = (
            f'<p><b>{html.escape(str(it.get("category", "")))}</b> — '
            f'{html.escape(str(it.get("description", "")))} '
            f'<span class="muted">(confidence {_fmt(it.get("confidence"))})'
            "</span></p>"
        )
    return (
        f'<details class="feature" id="feature-{fi}">'
        f"<summary><b>feature {fi}</b>"
        f'<span class="muted"> · max {_fmt(stats.get("max_activation"))}'
        f' · mean {_fmt(stats.get("mean_activation"))}'
        f' · n {stats.get("num_examples", stats.get("activation_count", "—"))}'
        "</span></summary>"
        f"{interp}"
        "<table><tr><th class=num>rank</th><th class=num>activation</th>"
        "<th class=num>sample</th><th class=num>t (ms)</th>"
        "<th>transcription</th><th>audio</th></tr>"
        f'{"".join(rows)}</table></details>'
    )


def _coactivation_section(co: dict | None) -> str:
    if not co or not co.get("top_pairs"):
        return ""
    rows = "".join(
        "<tr>"
        f'<td class="num"><a href="#feature-{p["feature_a"]}">'
        f'{p["feature_a"]}</a></td>'
        f'<td class="num"><a href="#feature-{p["feature_b"]}">'
        f'{p["feature_b"]}</a></td>'
        f'<td class="num">{p["jaccard"]:.3f}</td>'
        f'<td class="num">{p["co_count"]}</td>'
        "</tr>"
        for p in co["top_pairs"][:20]
    )
    return (
        "<h2>Co-activating feature pairs</h2>"
        '<p class="muted">Jaccard overlap of firing sets over '
        f'{co.get("num_tokens", "?")} tokens — high overlap suggests '
        "feature splitting or composition.</p>"
        "<table><tr><th class=num>feature a</th><th class=num>feature b"
        "</th><th class=num>jaccard</th><th class=num>co-count</th></tr>"
        f"{rows}</table>"
    )


def generate_dashboard(
    analysis_dir: str | Path,
    output: str | Path | None = None,
    audio_dir: str | Path | None = None,
    top_n: int | None = None,
    title: str = "whisper-sae feature dashboard",
) -> Path:
    """Build ``dashboard.html`` from an analysis directory.

    Args:
        analysis_dir: directory holding ``summary.json`` and
            ``features/feature_*.json`` (``FeatureReport.save_reports``).
        output: output path (default ``<analysis_dir>/dashboard.html``).
        audio_dir: audio-clip tree root (``extract_top_feature_audio``
            output) — clips are linked relative to the dashboard.
        top_n: cap on listed features (default: all in summary.json).

    Returns the written path.
    """
    analysis_dir = Path(analysis_dir)
    summary = json.loads((analysis_dir / "summary.json").read_text())
    out = Path(output) if output else analysis_dir / "dashboard.html"
    out.parent.mkdir(parents=True, exist_ok=True)
    clip_dir = Path(audio_dir) if audio_dir else None
    if clip_dir is None:
        default_clips = analysis_dir / "audio"
        clip_dir = default_clips if default_clips.is_dir() else None

    co = None
    co_path = analysis_dir / "coactivation.json"
    if co_path.exists():
        try:
            co = json.loads(co_path.read_text())
        except json.JSONDecodeError:
            co = None

    feats = summary.get("top_features", [])
    if top_n is not None:
        feats = feats[:top_n]
    max_act = max((f.get("max_activation", 0.0) for f in feats), default=1.0) or 1.0

    table_rows = []
    panels = []
    for f in feats:
        fi = f["feature_idx"]
        frac = max(0.0, min(1.0, f.get("max_activation", 0.0) / max_act))
        table_rows.append(
            "<tr>"
            f'<td class="num"><a href="#feature-{fi}">{fi}</a></td>'
            f'<td class="num">{_fmt(f.get("max_activation"))}</td>'
            f'<td class="num">{_fmt(f.get("mean_activation"))}</td>'
            f'<td class="num">{f.get("num_examples", "—")}</td>'
            f'<td><div class="bar"><span style="width:{frac * 100:.0f}%">'
            "</span></div></td></tr>"
        )
        rpath = analysis_dir / "features" / f"feature_{fi:05d}.json"
        if rpath.exists():
            panels.append(
                _feature_panel(json.loads(rpath.read_text()), out.parent, clip_dir)
            )

    doc = f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)}</title><style>{_CSS}</style></head><body>
<h1>{html.escape(title)}</h1>
<div class="stats">
  <div class="stat"><div class="v">{summary.get("num_features", "—")}</div>
    <div class="k">features</div></div>
  <div class="stat"><div class="v">{summary.get("samples_processed", "—")}</div>
    <div class="k">samples processed</div></div>
  <div class="stat"><div class="v">{summary.get("total_activations", "—")}</div>
    <div class="k">activation updates</div></div>
  <div class="stat"><div class="v">{len(feats)}</div>
    <div class="k">features listed</div></div>
</div>
<h2>Top features by max activation</h2>
<table><tr><th class=num>feature</th><th class=num>max act</th>
<th class=num>mean act</th><th class=num>examples</th><th></th></tr>
{"".join(table_rows)}</table>
{_coactivation_section(co)}<h2>Per-feature top examples</h2>
{"".join(panels)}
</body></html>
"""
    out.write_text(doc)
    return out
