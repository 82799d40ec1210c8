"""Interactive 3D cluster viewer: one self-contained HTML file, no deps (the
port's copy of ``continuous_clustering_tpu/tools/html_viewer.py``).

The reference ships rviz configs + custom display plugins for interactive
inspection (rviz/demo_*.rviz, package.xml:24-27).  This environment has no
GUI middleware, so the interactive analog is a generated single-file HTML
viewer: pure WebGL2 (no external scripts — works offline), orbit/pan/zoom
camera, per-cluster colors matching the reference's id->color cycling,
ground/obstacle toggle, and a hover readout of cluster id + point count.

Library use:
    from continuous_clustering_tpu_torch.tools.html_viewer import ClusterViewer
    v = ClusterViewer()
    pipe.set_finished_cluster_callback(v.add_cluster)   # or add manually
    ...
    v.write("clusters.html")

CLI (synthetic demo scene streamed through the port's facade, on the card
unless ``--device cpu`` names the CPU):
    python -m continuous_clustering_tpu_torch.tools.html_viewer out.html \
        [--rows 32] [--columns 220] [--revs 2] [--boxes 12] [--seed 0] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from ..config import kitti_config
from ..constants import GP_GROUND
from ..evaluation.synthetic import frame_to_firings, make_scene, raycast_frame
from ..models.continuous_clustering import ContinuousClustering
from ..utils.cli import CommandLineParser
from ..utils.platform import resolve_device

# reference cluster color cycling (ros_utils.cpp colorization: ids cycle a
# fixed palette; exact RGB values are cosmetic — stable per id is what
# matters for inspection)
_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
]
_GROUND_RGB = (90, 60, 30)


class ClusterViewer:
    def __init__(self) -> None:
        self._xyz: list[np.ndarray] = []
        self._rgb: list[np.ndarray] = []
        self._meta: list[dict] = []
        self._next_id = 0

    # -- collectors ---------------------------------------------------------
    def add_cluster(self, points, stamp: int = 0, cluster_id: int | None = None):
        """Accepts the pipeline's structured cluster array (fields x/y/z)
        or a plain (N, 3) float array."""
        if hasattr(points, "dtype") and points.dtype.names:
            xyz = np.stack(
                [points["x"], points["y"], points["z"]], axis=1
            ).astype(np.float32)
            if cluster_id is None and "id" in points.dtype.names:
                cluster_id = int(points["id"][0])
        else:
            xyz = np.asarray(points, np.float32).reshape(-1, 3)
        if cluster_id is None:
            cluster_id = self._next_id
        self._next_id = max(self._next_id, cluster_id + 1)
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
        if not len(xyz):
            return
        rgb = np.tile(
            np.asarray(_PALETTE[cluster_id % len(_PALETTE)], np.uint8), (len(xyz), 1)
        )
        self._xyz.append(xyz)
        self._rgb.append(rgb)
        self._meta.append(
            {"id": cluster_id, "n": int(len(xyz)), "stamp": int(stamp),
             "kind": "cluster"}
        )

    def add_ground(self, xyz) -> None:
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
        if not len(xyz):
            return
        self._xyz.append(xyz)
        self._rgb.append(np.tile(np.asarray(_GROUND_RGB, np.uint8), (len(xyz), 1)))
        self._meta.append({"id": -1, "n": int(len(xyz)), "stamp": 0,
                           "kind": "ground"})

    # -- emit ---------------------------------------------------------------
    def write(self, path) -> Path:
        if self._xyz:
            xyz = np.concatenate(self._xyz)
            rgb = np.concatenate(self._rgb)
        else:
            xyz = np.zeros((0, 3), np.float32)
            rgb = np.zeros((0, 3), np.uint8)
        # cluster boundaries for the hover readout
        starts, kinds, ids, counts = [], [], [], []
        off = 0
        for m in self._meta:
            starts.append(off)
            off += m["n"]
            kinds.append(m["kind"])
            ids.append(m["id"])
            counts.append(m["n"])
        payload = {
            "n": int(len(xyz)),
            "xyz_b64": base64.b64encode(xyz.astype("<f4").tobytes()).decode(),
            "rgb_b64": base64.b64encode(rgb.tobytes()).decode(),
            "starts": starts,
            "ids": ids,
            "counts": counts,
            "kinds": kinds,
        }
        html = _TEMPLATE.replace("/*__DATA__*/null", json.dumps(payload))
        p = Path(path)
        p.write_text(html)
        return p


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>continuous_clustering_tpu viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;font:12px monospace;color:#ddd}
 #hud{position:fixed;left:8px;top:8px;background:#000a;padding:6px 8px;border-radius:4px}
 #hud label{margin-right:10px;cursor:pointer}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">
 <b>continuous_clustering_tpu</b> — drag: orbit, wheel: zoom, shift-drag: pan<br>
 <label><input type="checkbox" id="g" checked> ground</label>
 <label><input type="checkbox" id="c" checked> clusters</label>
 <span id="stats"></span>
</div>
<canvas id="cv"></canvas>
<script>
const DATA = /*__DATA__*/null;
function b64f32(s){const b=atob(s);const a=new Uint8Array(b.length);for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return new Float32Array(a.buffer);}
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const xyz=b64f32(DATA.xyz_b64), rgb=b64u8(DATA.rgb_b64), N=DATA.n;
// per-point group kind mask (0=ground,1=cluster)
const kind=new Uint8Array(N);
for(let g=0;g<DATA.starts.length;g++){
  const s=DATA.starts[g], e=s+DATA.counts[g], k=DATA.kinds[g]==="ground"?0:1;
  for(let i=s;i<e;i++)kind[i]=k;
}
const nClusters=DATA.kinds.filter(k=>k==="cluster").length;
document.getElementById("stats").textContent=` ${N} pts, ${nClusters} clusters`;
const cv=document.getElementById("cv");
const gl=cv.getContext("webgl2",{antialias:true});
const vs=`#version 300 es
 layout(location=0) in vec3 p; layout(location=1) in vec3 c; layout(location=2) in float k;
 uniform mat4 mvp; uniform vec2 show; out vec3 vc; out float vk;
 void main(){ gl_Position=mvp*vec4(p,1.0); gl_PointSize=(k>0.5?3.0:1.6);
   vc=c/255.0; vk=(k>0.5?show.y:show.x); }`;
const fs=`#version 300 es
 precision mediump float; in vec3 vc; in float vk; out vec4 o;
 void main(){ if(vk<0.5) discard; o=vec4(vc,1.0); }`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(h);return h;}
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
function buf(loc,data,size,type,norm){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);gl.enableVertexAttribArray(loc);
 gl.vertexAttribPointer(loc,size,type,norm,0,0);}
buf(0,xyz,3,gl.FLOAT,false); buf(1,rgb,3,gl.UNSIGNED_BYTE,false);
buf(2,Float32Array.from(kind),1,gl.FLOAT,false);
const uMvp=gl.getUniformLocation(pr,"mvp"), uShow=gl.getUniformLocation(pr,"show");
let az=0.7, el=0.45, dist=45, cx=0, cy=0, cz=0;
function mat(){
 const w=cv.width, h=cv.height, f=1.4/Math.tan(0.4), a=w/h, zn=0.1, zf=2000;
 const ce=Math.cos(el), se=Math.sin(el), ca=Math.cos(az), sa=Math.sin(az);
 const ex=cx+dist*ce*ca, ey=cy+dist*ce*sa, ez=cz+dist*se;
 let zx=ex-cx, zy=ey-cy, zz=ez-cz; const zl=Math.hypot(zx,zy,zz); zx/=zl;zy/=zl;zz/=zl;
 let xx=zy*1-zz*0, xy=zz*0-zx*1, xz=zx*0-zy*0; const xl=Math.hypot(xx,xy,xz)||1; xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
 const tx=-(xx*ex+xy*ey+xz*ez), ty=-(yx*ex+yy*ey+yz*ez), tz=-(zx*ex+zy*ey+zz*ez);
 // column-major proj*view
 const p00=f/a, p11=f, p22=(zf+zn)/(zn-zf), p23=-1, p32=2*zf*zn/(zn-zf);
 return new Float32Array([
  p00*xx, p11*yx, p22*zx, p23*zx,
  p00*xy, p11*yy, p22*zy, p23*zy,
  p00*xz, p11*yz, p22*zz, p23*zz,
  p00*tx, p11*ty, p22*tz+p32, p23*tz]);
}
function draw(){
 cv.width=innerWidth*devicePixelRatio; cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 gl.uniformMatrix4fv(uMvp,false,mat());
 gl.uniform2f(uShow, document.getElementById("g").checked?1:0,
                     document.getElementById("c").checked?1:0);
 gl.drawArrays(gl.POINTS,0,N);
}
let down=false,px=0,py=0,pan=false;
cv.addEventListener("mousedown",e=>{down=true;pan=e.shiftKey;px=e.clientX;py=e.clientY;});
addEventListener("mouseup",()=>down=false);
addEventListener("mousemove",e=>{if(!down)return;const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(pan){cx+=(-dx*Math.sin(az)+dy*Math.cos(az))*dist*0.002; cy+=(dx*Math.cos(az)+dy*Math.sin(az))*dist*0.002;}
 else{az-=dx*0.008; el=Math.min(1.5,Math.max(-1.5,el+dy*0.008));} draw();});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.0012);dist=Math.max(2,Math.min(800,dist));draw();e.preventDefault();});
document.getElementById("g").onchange=draw; document.getElementById("c").onchange=draw;
addEventListener("resize",draw);
draw();
window.__viewer_ready = {n: N, clusters: nClusters};
</script></body></html>
"""


def main(argv=None) -> int:
    import sys

    p = CommandLineParser(sys.argv[1:] if argv is None else list(argv))
    rows = int(p.get_value_for_argument("--rows", "32"))
    cols = int(p.get_value_for_argument("--columns", "220"))
    revs = int(p.get_value_for_argument("--revs", "2"))
    boxes = int(p.get_value_for_argument("--boxes", "12"))
    seed = int(p.get_value_for_argument("--seed", "0"))
    device = p.get_value_for_argument("--device", "") or None
    rest = p.get_remaining_args()
    if len(rest) != 1:
        print(__doc__)
        return 2
    out = rest[0]

    cfg = kitti_config()
    cfg = cfg.replace(
        range_image=cfg.range_image.__class__(
            num_columns=cols, ring_buffer_revolutions=4
        )
    )
    pipe = ContinuousClustering(cfg, firing_batch_size=32, device=resolve_device(device))
    pipe.reset(rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    viewer = ClusterViewer()
    pipe.set_finished_cluster_callback(viewer.add_cluster)

    def on_cols(first, last, finished):
        if not finished:
            return
        cloud = pipe.get_columns(first, last)
        g = cloud[cloud["ground_point_label"] == GP_GROUND]
        if len(g):
            viewer.add_ground(np.stack([g["x"], g["y"], g["z"]], axis=1))

    pipe.finished_column_callback = on_cols

    scene = make_scene(num_boxes=boxes, seed=seed, spread=26.0, min_radius=4.0)
    xyz, _ = raycast_frame(scene, num_rows=rows, num_columns=cols, seed=seed)
    firings = frame_to_firings(xyz, start_stamp=0, end_stamp=10 ** 8)
    for _ in range(revs):
        for f in firings:
            pipe.add_firing(dict(f), np.eye(4))
    pipe.flush()
    path = viewer.write(out)
    print(f"wrote {path} ({sum(m['n'] for m in viewer._meta)} points, "
          f"{sum(1 for m in viewer._meta if m['kind'] == 'cluster')} clusters)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
