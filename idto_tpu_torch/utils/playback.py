"""Trajectory playback export: one self-contained WebGL HTML file
(counterpart of ``idto_tpu/utils/playback.py``).

The solved trajectory is exported after the solve as one .html file with
an embedded WebGL renderer and the keyframed scene inline: no network
fetch, open it anywhere.  Scene content: every collision geometry of the
model (sphere, box, capsule, cylinder, halfspace; a convex hull is drawn
as its local bounding box), posed at each knot by the port's forward
kinematics.  The HTML template is the JAX package's, byte for byte.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from idto_tpu_torch.models.model import GeomType, Model
from idto_tpu_torch.soa.kinematics import forward_kinematics


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z); numpy, on the host."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0
    x = abs(x) * np.sign(R[2, 1] - R[1, 2]) if x > 1e-12 else x
    y = abs(y) * np.sign(R[0, 2] - R[2, 0]) if y > 1e-12 else y
    z = abs(z) * np.sign(R[1, 0] - R[0, 1]) if z > 1e-12 else z
    q = np.array([w, x, y, z])
    n = np.linalg.norm(q)
    return q / n if n > 0 else np.array([1.0, 0.0, 0.0, 0.0])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trajectory_scene_data(model: Model, qs, dt: float) -> dict:
    """Keyframed scene description for a knot trajectory.

    qs: (T+1, nq), a tensor on any device or an array.  Returns a JSON-able
    dict:
      geoms:  [{type, params, name, body}]
      frames: (T+1) x ng x 7 [qw qx qy qz px py pz] world poses
      dt:     knot spacing in seconds
    """
    ref = model.R_pj
    q = torch.as_tensor(_host(qs), dtype=ref.dtype, device=ref.device)
    with torch.no_grad():
        R, p = forward_kinematics(model, q.T)
    R_links = _host(R.permute(3, 2, 0, 1))  # (T+1, nl, 3, 3)
    p_links = _host(p.permute(2, 1, 0))  # (T+1, nl, 3)
    n_knots = q.shape[0]

    g = model.geoms
    gR = _host(g.R)
    gp = _host(g.p)
    gparams = _host(g.params)

    geoms = []
    frames = np.zeros((n_knots, g.num_geoms, 7))
    for i in range(g.num_geoms):
        body = g.bodies[i]
        gtype = GeomType(g.types[i])
        params = [float(v) for v in gparams[i]]
        p_extra = np.zeros(3)
        if gtype == GeomType.CONVEX:
            # The renderer draws primitives: a hull is shown as its local
            # bounding box (contact uses the hull).
            verts = _host(g.verts[i])
            lo, hi = verts.min(axis=0), verts.max(axis=0)
            params = [float(v) for v in 0.5 * (hi - lo)]
            p_extra = 0.5 * (hi + lo)
            type_name = "box"
        else:
            type_name = gtype.name.lower()
        geoms.append({
            "type": type_name,
            "params": params,
            "name": g.names[i] if i < len(g.names) else f"geom{i}",
            "body": int(body),
        })
        gp_i = gp[i] + gR[i] @ p_extra
        for t in range(n_knots):
            if body < 0:  # world-fixed
                Rw, pw = gR[i], gp_i
            else:
                Rw = R_links[t, body] @ gR[i]
                pw = R_links[t, body] @ gp_i + p_links[t, body]
            frames[t, i, :4] = _rot_to_quat_np(Rw)
            frames[t, i, 4:] = pw
    return {
        "geoms": geoms,
        "frames": np.round(frames, 6).tolist(),
        "dt": float(dt),
    }


_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#1c1e22;color:#cfd2d6;font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;left:0;right:0;bottom:0;padding:8px 12px;display:flex;
      gap:10px;align-items:center;background:rgba(20,22,25,.85)}
 #hud input[type=range]{flex:1}
 button{background:#2e3238;color:#cfd2d6;border:1px solid #4a4f57;
        border-radius:4px;padding:4px 12px;cursor:pointer}
 #title{position:fixed;top:8px;left:12px;opacity:.8}
</style></head><body>
<canvas id="c"></canvas>
<div id="title">__TITLE__ &mdash; drag: orbit, shift-drag: pan, wheel: zoom</div>
<div id="hud">
 <button id="play">pause</button>
 <input type="range" id="scrub" min="0" max="0" step="1" value="0">
 <span id="tlabel">t=0.000s</span>
 <select id="speed"><option value="0.25">0.25x</option>
  <option value="1" selected>1x</option><option value="4">4x</option></select>
</div>
<script>
const SCENE = __SCENE_JSON__;
// ---------- tiny mat4/quat lib ----------
function m4ident(){return new Float32Array([1,0,0,0,0,1,0,0,0,0,1,0,0,0,0,1])}
function m4mul(a,b){const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s}return o}
function m4persp(fov,asp,n,f){const t=1/Math.tan(fov/2);
 return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
  0,0,2*f*n/(n-f),0])}
function m4lookat(e,c,u){const z=norm3(sub3(e,c)),x=norm3(cross3(u,z)),
 y=cross3(z,x);return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
 x[2],y[2],z[2],0, -dot3(x,e),-dot3(y,e),-dot3(z,e),1])}
function quat2m4(q,p){const[w,x,y,z]=q;
 return new Float32Array([1-2*(y*y+z*z),2*(x*y+w*z),2*(x*z-w*y),0,
  2*(x*y-w*z),1-2*(x*x+z*z),2*(y*z+w*x),0,
  2*(x*z+w*y),2*(y*z-w*x),1-2*(x*x+y*y),0, p[0],p[1],p[2],1])}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]]}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]]}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]}
function norm3(a){const n=Math.hypot(a[0],a[1],a[2])||1;
 return[a[0]/n,a[1]/n,a[2]/n]}
// ---------- primitive meshes (positions + normals) ----------
function meshSphere(r,la=14,lo=20){const P=[],N=[],I=[];
 for(let i=0;i<=la;i++){const th=Math.PI*i/la;
  for(let j=0;j<=lo;j++){const ph=2*Math.PI*j/lo;
   const n=[Math.sin(th)*Math.cos(ph),Math.sin(th)*Math.sin(ph),Math.cos(th)];
   N.push(...n);P.push(r*n[0],r*n[1],r*n[2])}}
 for(let i=0;i<la;i++)for(let j=0;j<lo;j++){const a=i*(lo+1)+j,b=a+lo+1;
  I.push(a,b,a+1,b,b+1,a+1)}return{P,N,I}}
function meshBox(hx,hy,hz){const P=[],N=[],I=[];
 const faces=[[[1,0,0],[0,1,0],[0,0,1]],[[-1,0,0],[0,0,1],[0,1,0]],
  [[0,1,0],[0,0,1],[1,0,0]],[[0,-1,0],[1,0,0],[0,0,1]],
  [[0,0,1],[1,0,0],[0,1,0]],[[0,0,-1],[0,1,0],[1,0,0]]];
 const h=[hx,hy,hz];
 for(const[n,u,v]of faces){const b=P.length/3;
  for(const[su,sv]of[[-1,-1],[1,-1],[1,1],[-1,1]]){
   for(let k=0;k<3;k++)P.push((n[k]+su*u[k]+sv*v[k])*h[k]);
   N.push(...n)}
  I.push(b,b+1,b+2,b,b+2,b+3)}return{P,N,I}}
function meshCylinder(r,hl,caps=true,seg=24){const P=[],N=[],I=[];
 for(const s of[-1,1])for(let j=0;j<=seg;j++){const a=2*Math.PI*j/seg,
  c=Math.cos(a),si=Math.sin(a);P.push(r*c,r*si,s*hl);N.push(c,si,0)}
 for(let j=0;j<seg;j++){const a=j,b=j+seg+1;
  I.push(a,b,a+1,b,b+1,a+1)}
 if(caps)for(const s of[-1,1]){const b=P.length/3;P.push(0,0,s*hl);
  N.push(0,0,s);for(let j=0;j<=seg;j++){const a=2*Math.PI*j/seg;
   P.push(r*Math.cos(a),r*Math.sin(a),s*hl);N.push(0,0,s)}
  for(let j=0;j<seg;j++)s>0?I.push(b,b+1+j,b+2+j):I.push(b,b+2+j,b+1+j)}
 return{P,N,I}}
function meshCapsule(r,hl,seg=20,rings=8){const{P,N,I}=meshCylinder(r,hl,false,seg);
 for(const s of[-1,1]){const b=P.length/3;
  for(let i=0;i<=rings;i++){const th=(Math.PI/2)*i/rings;
   for(let j=0;j<=seg;j++){const ph=2*Math.PI*j/seg;
    const n=[Math.cos(th)*Math.cos(ph),Math.cos(th)*Math.sin(ph),
             s*Math.sin(th)];
    N.push(...n);P.push(r*n[0],r*n[1],r*n[2]+s*hl)}}
  for(let i=0;i<rings;i++)for(let j=0;j<seg;j++){
   const a=b+i*(seg+1)+j,c=a+seg+1;
   s>0?I.push(a,c,a+1,c,c+1,a+1):I.push(a,a+1,c,c,a+1,c+1)}}
 return{P,N,I}}
function meshPlane(sz=6){const P=[],N=[],I=[];
 for(const[x,y]of[[-1,-1],[1,-1],[1,1],[-1,1]]){P.push(sz*x,sz*y,0);
  N.push(0,0,1)}I.push(0,1,2,0,2,3);return{P,N,I}}
function meshFor(g){const p=g.params;
 if(g.type==="sphere")return meshSphere(p[0]);
 if(g.type==="box")return meshBox(p[0],p[1],p[2]);
 if(g.type==="capsule")return meshCapsule(p[0],p[1]);
 if(g.type==="cylinder")return meshCylinder(p[0],p[1]);
 return meshPlane()}
// ---------- WebGL ----------
const canvas=document.getElementById("c"),gl=canvas.getContext("webgl");
const VS=`attribute vec3 aP;attribute vec3 aN;uniform mat4 uM,uV,uP;
 varying vec3 vN;varying vec3 vW;void main(){vec4 w=uM*vec4(aP,1.0);
 vW=w.xyz;vN=mat3(uM[0].xyz,uM[1].xyz,uM[2].xyz)*aN;
 gl_Position=uP*uV*w;}`;
const FS=`precision mediump float;varying vec3 vN;varying vec3 vW;
 uniform vec3 uC;void main(){vec3 n=normalize(vN);
 vec3 l=normalize(vec3(0.4,0.3,0.85));
 float d=max(dot(n,l),0.0)*0.7+0.35;
 float g=1.0;
 gl_FragColor=vec4(uC*d*g,1.0);}`;
function shader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);return s}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const loc={aP:gl.getAttribLocation(prog,"aP"),
 aN:gl.getAttribLocation(prog,"aN"),uM:gl.getUniformLocation(prog,"uM"),
 uV:gl.getUniformLocation(prog,"uV"),uP:gl.getUniformLocation(prog,"uP"),
 uC:gl.getUniformLocation(prog,"uC")};
gl.enable(gl.DEPTH_TEST);
const PALETTE=[[0.85,0.45,0.2],[0.3,0.6,0.9],[0.5,0.8,0.4],[0.9,0.75,0.3],
 [0.7,0.5,0.9],[0.9,0.4,0.55],[0.45,0.8,0.8],[0.75,0.75,0.75]];
const bodies=SCENE.geoms.map((g,i)=>{const m=meshFor(g);
 const vb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,vb);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(m.P),gl.STATIC_DRAW);
 const nb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,nb);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(m.N),gl.STATIC_DRAW);
 const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
 gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,new Uint16Array(m.I),gl.STATIC_DRAW);
 const col=g.type==="halfspace"?[0.32,0.34,0.38]
  :PALETTE[(g.body>=0?g.body:i)%PALETTE.length];
 return{vb,nb,ib,n:m.I.length,col}});
// camera: orbit around scene centroid
let allP=[];for(const f of SCENE.frames)for(const g of f)
 allP.push([g[4],g[5],g[6]]);
let ctr=[0,0,0];for(const p of allP){ctr[0]+=p[0];ctr[1]+=p[1];ctr[2]+=p[2]}
ctr=ctr.map(v=>v/Math.max(1,allP.length));
let rad=0.5;for(const p of allP)rad=Math.max(rad,
 Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]));
let az=0.7,el=0.45,dist=rad*3.5,pan=[0,0,0];
canvas.addEventListener("mousedown",e=>{let lx=e.clientX,ly=e.clientY;
 const mv=ev=>{const dx=ev.clientX-lx,dy=ev.clientY-ly;lx=ev.clientX;
  ly=ev.clientY;
  if(ev.shiftKey){pan[0]-=dx*dist*0.0015*Math.sin(az);
   pan[1]+=dx*dist*0.0015*Math.cos(az);pan[2]+=dy*dist*0.0015}
  else{az-=dx*0.008;el=Math.min(1.5,Math.max(-1.5,el+dy*0.008))}};
 const up=()=>{removeEventListener("mousemove",mv);
  removeEventListener("mouseup",up)};
 addEventListener("mousemove",mv);addEventListener("mouseup",up)});
canvas.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
 e.preventDefault()},{passive:false});
// playback state
let frame=0,playing=true,tAcc=0,last=0;
const scrub=document.getElementById("scrub");scrub.max=SCENE.frames.length-1;
const playBtn=document.getElementById("play"),
 tlabel=document.getElementById("tlabel"),
 speedSel=document.getElementById("speed");
playBtn.onclick=()=>{playing=!playing;playBtn.textContent=playing?"pause":"play"};
scrub.oninput=()=>{frame=+scrub.value;playing=false;
 playBtn.textContent="play"};
function draw(ts){requestAnimationFrame(draw);
 const dtv=(ts-last)/1000;last=ts;
 if(playing){tAcc+=dtv*(+speedSel.value);
  while(tAcc>=SCENE.dt){tAcc-=SCENE.dt;frame=(frame+1)%SCENE.frames.length}}
 frame=Math.min(frame,SCENE.frames.length-1);
 scrub.value=frame;tlabel.textContent="t="+(frame*SCENE.dt).toFixed(3)+"s";
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.11,0.12,0.13,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const eye=[ctr[0]+pan[0]+dist*Math.cos(el)*Math.cos(az),
  ctr[1]+pan[1]+dist*Math.cos(el)*Math.sin(az),
  ctr[2]+pan[2]+dist*Math.sin(el)];
 const V=m4lookat(eye,[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]],[0,0,1]);
 const P=m4persp(0.9,canvas.width/canvas.height,0.01,100*rad);
 gl.uniformMatrix4fv(loc.uV,false,V);gl.uniformMatrix4fv(loc.uP,false,P);
 const fr=SCENE.frames[frame];
 for(let i=0;i<bodies.length;i++){const b=bodies[i],g=fr[i];
  gl.uniformMatrix4fv(loc.uM,false,
   quat2m4([g[0],g[1],g[2],g[3]],[g[4],g[5],g[6]]));
  gl.uniform3fv(loc.uC,b.col);
  gl.bindBuffer(gl.ARRAY_BUFFER,b.vb);
  gl.vertexAttribPointer(loc.aP,3,gl.FLOAT,false,0,0);
  gl.enableVertexAttribArray(loc.aP);
  gl.bindBuffer(gl.ARRAY_BUFFER,b.nb);
  gl.vertexAttribPointer(loc.aN,3,gl.FLOAT,false,0,0);
  gl.enableVertexAttribArray(loc.aN);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,b.ib);
  gl.drawElements(gl.TRIANGLES,b.n,gl.UNSIGNED_SHORT,0)}}
requestAnimationFrame(draw);
</script></body></html>
"""


def export_html(
    model: Model,
    qs,
    dt: float,
    path: str,
    title: Optional[str] = None,
) -> str:
    """Write a standalone playback HTML for the knot trajectory ``qs``.
    Returns the absolute output path."""
    scene = trajectory_scene_data(model, qs, dt)
    html = _HTML_TEMPLATE.replace(
        "__TITLE__", title or "idto_tpu trajectory"
    ).replace("__SCENE_JSON__", json.dumps(scene))
    path = os.path.abspath(path)
    with open(path, "w") as f:
        f.write(html)
    return path
