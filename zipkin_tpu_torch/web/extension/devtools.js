"use strict";
// Register the "Zipkin" devtools panel (works in Chrome and Firefox;
// Firefox aliases chrome.* for devtools APIs).
chrome.devtools.panels.create("Zipkin", "", "panel.html", () => {});
