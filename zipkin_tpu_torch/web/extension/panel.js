"use strict";
// Watch finished requests; any response echoing X-B3-TraceId (the
// ZipkinWSGIMiddleware contract) gets a row linking into the UI's
// #trace= deep link. Reference role: zipkin-browser-extension's
// request listing; this rebuild uses only devtools.network, so it
// needs no host permissions.
const $ = (id) => document.getElementById(id);
const esc = (s) => String(s).replace(/[&<>"]/g,
  (c) => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}[c]));
let n = 0;

function headerValue(headers, name) {
  name = name.toLowerCase();
  for (const h of headers || [])
    if (h.name.toLowerCase() === name) return h.value;
  return null;
}

function addRow(method, url, status, traceId) {
  $("empty").style.display = "none";
  const base = $("base").value.replace(/\/+$/, "");
  const tr = document.createElement("tr");
  tr.innerHTML = `<td>${esc(method)}</td>
    <td class="url" title="${esc(url)}">${esc(url)}</td>
    <td>${esc(status)}</td>
    <td class="mono"><a href="${esc(base)}/#trace=${esc(traceId)}"
      target="_blank">${esc(traceId)}</a></td>`;
  $("rows").appendChild(tr);
  n += 1;
  $("count").textContent = n + " traced";
}

chrome.devtools.network.onRequestFinished.addListener((req) => {
  try {
    const hs = req.response && req.response.headers;
    const tid = headerValue(hs, "X-B3-TraceId");
    if (!tid || !/^[0-9a-fA-F]+$/.test(tid)) return;
    // Unsampled requests were never recorded — a link would 404.
    if (headerValue(hs, "X-B3-Sampled") === "0") return;
    addRow(req.request.method, req.request.url,
           req.response.status, tid);
  } catch (e) { /* never break the panel on a malformed entry */ }
});

$("clear").onclick = () => {
  for (const tr of [...$("rows").querySelectorAll("tr")].slice(1))
    tr.remove();
  n = 0;
  $("count").textContent = "";
  $("empty").style.display = "";
};
