"""Host-side pieces of the policy engine the compiler needs: anchor
parsing, the leaf pattern operators and the condition operators."""
