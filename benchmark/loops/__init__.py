"""One module per loop kind.  Each names the program entry its window
drives (ENTRY), the end-to-end metrics it can report (REPORTS), and
builds a Loop: set-up in the constructor, `step()` the timed call, and
`check()` the numbers compared with the plain reference once the window
has closed."""
