"""Fills, one module each.  A fill is an object with:

- ``swf_style()``: its FILLSTYLE bytes in a DefineShape3;
- ``port()``: the program's fill object (imports the program inside);
- ``paint(cxform, aff, height, width, dtype, device, geo_dtype)``: its
  straight colours for the reference, a (4,) or (H, W, 4) tensor, under
  the instance's colour transform and matrix;
- ``nbytes()`` and ``ops()``: the bytes it reads once and the operations
  it adds to each pixel it covers, for the work count.
"""
