"""Tkinter GUI mirroring the CLI options (port of
``deep_image_matching_tpu/gui.py``): a small dialog to pick the image and
output folders, the pipeline preset, matching strategy, quality and tiling,
returning the same args dict the CLI produces. tkinter is imported when the
dialog opens.
"""

from __future__ import annotations

from typing import Optional


def gui() -> dict:
    import tkinter as tk
    from tkinter import filedialog, ttk

    from .config import confs, opt_zoo

    result: dict = {}

    try:
        root = tk.Tk()
    except tk.TclError as e:
        raise SystemExit(
            f"Cannot open the GUI: no display available ({e}). "
            "Run without --gui, or set DISPLAY / use X forwarding."
        ) from None
    root.title("Deep Image Matching (PyTorch)")

    paths = {"images": tk.StringVar(), "outs": tk.StringVar()}

    def browse(var, directory=True):
        def _cb():
            p = filedialog.askdirectory() if directory else filedialog.askopenfilename()
            if p:
                var.set(p)
        return _cb

    row = 0
    for label, key in (("Image folder", "images"), ("Output folder", "outs")):
        tk.Label(root, text=label).grid(row=row, column=0, sticky="w", padx=6, pady=4)
        tk.Entry(root, textvariable=paths[key], width=48).grid(row=row, column=1)
        tk.Button(root, text="Browse", command=browse(paths[key])).grid(row=row, column=2)
        row += 1

    selectors = {}
    options = {
        "pipeline": list(confs.keys()),
        "strategy": opt_zoo["matching_strategy"],
        "quality": ["lowest", "low", "medium", "high", "highest"],
        "tiling": ["none", "preselection", "grid", "exhaustive",
                   "preselection_affine_transform"],
    }
    defaults = {
        "pipeline": "superpoint+lightglue",
        "strategy": "matching_lowres",
        "quality": "high",
        "tiling": "none",
    }
    for key, opts in options.items():
        tk.Label(root, text=key.capitalize()).grid(row=row, column=0, sticky="w", padx=6, pady=4)
        var = tk.StringVar(value=defaults[key])
        ttk.Combobox(root, textvariable=var, values=opts, state="readonly", width=45).grid(
            row=row, column=1
        )
        selectors[key] = var
        row += 1

    flags = {}
    for key, label in (
        ("upright", "Rotate images upright"),
        ("skip_reconstruction", "Skip reconstruction"),
        ("force", "Overwrite existing output"),
    ):
        var = tk.BooleanVar(value=False)
        tk.Checkbutton(root, text=label, variable=var).grid(
            row=row, column=1, sticky="w"
        )
        flags[key] = var
        row += 1

    def run():
        result.update(
            {
                "images": paths["images"].get() or None,
                "outs": paths["outs"].get() or None,
                "pipeline": selectors["pipeline"].get(),
                "strategy": selectors["strategy"].get(),
                "quality": selectors["quality"].get(),
                "tiling": selectors["tiling"].get(),
                **{k: v.get() for k, v in flags.items()},
            }
        )
        root.destroy()

    tk.Button(root, text="Run", command=run, width=20).grid(
        row=row, column=1, pady=10
    )
    root.mainloop()
    if not result:
        raise SystemExit("GUI closed without running")
    return result
