"""The yardstick's own arithmetic: operations, bytes and the card's
published peaks, frozen here so that a change to the program cannot move
the denominators it is judged by."""
