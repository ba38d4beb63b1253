"""Characters, one module each.  A character is an object with a ``cid``
and:

- ``swf_tag()``: its definition tag (``swfwrite``'s records);
- ``port_definition()`` and ``port_instance(inst, definition)``: the
  program's definition and display instance (``port``);
- ``outlines(inst, aff)``: for the reference, its closed polylines in
  twips (f64, curves cut into chords under ``aff``) and its fill;
- ``work(inst)``: for the work count, (bytes of its definition, its
  contours' anchors in twips, operations it adds to each edge, its fill).
"""
