"""Faults planted under a TPS surface cell's timed path, each of which its
comparison has to catch:

* ``stale``: every call returns the first call's spline and surfaces (a
  state that is never updated);
* ``half_stations``: the fit sees only the first half of the stations (the
  rest left out, the fit taken over what is left), its fitted values
  predicted at all of them;
* ``wrong_response``: the last response's surface is the one before it, as
  a launch that writes into the wrong response's slot.

``entry_with(fault)`` is the cell's entry with the port's TPS calls broken
underneath; the harness runs it as it runs the entry.
"""
from __future__ import annotations

import types


from portbench.entries import tps_surface

FAULTS = ("stale", "half_stations", "wrong_response")


def broken_tps(port_tps, fault: str):
    memo = {}

    def tps_fit_auto(coords, ys, **kw):
        if fault == "half_stations":
            h = coords.shape[0] // 2
            model = port_tps.tps_fit_auto(coords[:h], ys[:h], **kw)
            return model._replace(fitted=port_tps.tps_predict(model, coords))
        model = port_tps.tps_fit_auto(coords, ys, **kw)
        if fault == "stale":
            return memo.setdefault("model", model)
        return model

    def tps_predict_grid(model, grid, **kw):
        surf = port_tps.tps_predict_grid(model, grid, **kw)
        if fault == "wrong_response":
            surf = surf.clone()
            surf[..., -1] = surf[..., -2]
        if fault == "stale":
            return memo.setdefault("surf", surf)
        return surf

    return types.SimpleNamespace(tps_fit_auto=tps_fit_auto, tps_predict_grid=tps_predict_grid)


def entry_with(fault: str):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")

    def prepare(cell, seed, device):
        st = tps_surface.prepare(cell, seed, device)
        st.tps = broken_tps(st.tps, fault)
        return st

    return types.SimpleNamespace(prepare=prepare, call=tps_surface.call, release=tps_surface.release,
                                 judge=tps_surface.judge)


__all__ = ["FAULTS", "broken_tps", "entry_with"]
