"""The paper's evaluation on the port: one function per table or figure
(``paper_figures``), the FPGA cycle model they rest on
(``edge_cost_model``), the roofline table of the dry run
(``roofline_table``) and the harness that runs them (``run``)."""
